"""bagel_tpu_torch int4_matmul (B4) vs bagel_tpu's Pallas int4_matmul.

On CPU tensors the port's wrapper takes its plain version (bf16 x times the
weight dequantized to bf16, f32 sums, bf16 out). Bar: within one bf16 ulp
of the Pallas kernel in interpret mode (the two sum the same exact f32
products in another order, then round to bf16), including nk > 64 scale
groups (the JAX kernel's zero-padded k-groups) and the wide shapes of
tests/test_quant.py. The CUDA kernel is held against the plain version on
the card.

Where cancellation leaves an output far below its terms, the two f32 sums
may differ by more than a bf16 ulp of it: there the bar adds the f32 sums'
own error bound, K 2^-24 sum_k |x_k w_k|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bagel_tpu.ops import int4_matmul as j4
from bagel_tpu.utils.quant import quantize_weight_int4 as jquantize_int4
from bagel_tpu_torch.ops import int4_matmul as t4
from bagel_tpu_torch.utils.bridge import params_from_numpy
from bagel_tpu_torch.utils.quant import dequantize_weight4, quantize_weight_int4


def _bf16_ulp(x):
    """One bf16 ulp of each value (of the smallest normal near 0)."""
    a = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _case(seed, m, in_, out, wscale=0.1):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((in_, out)) * wscale).astype(np.float32)
    x = rng.standard_normal((m, in_)).astype(np.float32)
    leaf = jquantize_int4(jnp.asarray(w), group=128)
    want = np.asarray(j4.int4_matmul(jnp.asarray(x), leaf["w_p4"], leaf["scale4"],
                                     interpret=True)).astype(np.float32)
    tleaf = params_from_numpy({k: np.asarray(v) for k, v in leaf.items()}, "cpu")
    got = t4.int4_matmul(torch.tensor(x), tleaf["w_p4"], tleaf["scale4"])
    wd = dequantize_weight4(tleaf, torch.bfloat16).double().numpy()
    xb = torch.tensor(x).bfloat16().double().numpy()
    sum_err = in_ * 2.0 ** -24 * (np.abs(xb) @ np.abs(wd))
    return got, want, sum_err


@pytest.mark.parametrize("m,in_,out", [
    (1, 256, 512),       # decode, two scale groups
    (3, 256, 512),
    (8, 256, 512),
    (5, 512, 1024),      # the wide shape of tests/test_quant.py
    (2, 66 * 128, 512),  # nk = 66 > _KT_MAX: the JAX kernel pads its k-groups
    (64, 384, 512),      # the most rows the kernel takes
])
def test_plain_matches_pallas(m, in_, out):
    got, want, sum_err = _case(m + in_, m, in_, out)
    assert got.dtype == torch.bfloat16 and got.shape == (m, out)
    g = got.float().numpy()
    assert np.abs(want).max() > 0
    err = np.abs(g - want)
    assert (err <= _bf16_ulp(want) + sum_err).all()
    assert (err <= _bf16_ulp(want)).mean() > 0.999  # the sum term is for a few tiny outputs
    assert t4.int4_matmul.launches == 0  # CPU tensors never reach the kernel


def test_plain_reads_low_nibble_as_even_row():
    """Packed row j: input row 2j in the low nibble, 2j+1 in the high one."""
    w = np.zeros((256, 512), np.float32)
    w[0, :] = 7.0  # row 0 -> low nibble of packed row 0
    w[1, :] = -7.0
    w[128, 0] = 1.0  # keeps the second group's scale sane
    leaf = quantize_weight_int4(torch.tensor(w))
    x = torch.zeros((1, 256))
    x[0, 0] = 1.0
    assert t4.int4_matmul(x, leaf["w_p4"], leaf["scale4"])[0, 5].item() == 7.0
    x[0, 0], x[0, 1] = 0.0, 1.0
    assert t4.int4_matmul(x, leaf["w_p4"], leaf["scale4"])[0, 5].item() == -7.0


def test_eligibility_follows_the_jax_rule_on_cuda():
    leaf = quantize_weight_int4(torch.zeros((256, 512)))
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert t4.int4_gemv_eligible(1, leaf, cuda)
    assert t4.int4_gemv_eligible(64, leaf, cuda)
    assert not t4.int4_gemv_eligible(65, leaf, cuda)  # prefill: the dequant path
    assert not t4.int4_gemv_eligible(1, leaf, cpu)  # the CPU dequantizes, as JAX
    assert not t4.int4_gemv_eligible(1, {"w_q": None}, cuda)
    odd = quantize_weight_int4(torch.zeros((256, 528)))
    assert not t4.int4_gemv_eligible(1, odd, cuda)


_SHAPES = [(3584, 4608), (3584, 512), (3584, 3584), (3584, 37888), (18944, 3584),
           (3584, 18944)]


@pytest.mark.parametrize("in_,out,rows", [
    pytest.param(i, o, r, id=f"{i}-{o}" if r == 1 else f"{i}-{o}-rows{r}")
    for r in (1, 64) for i, o in _SHAPES])
def test_split_k_fills_the_card(in_, out, rows):
    """Every decode linear of the MoT (fused qkv, k/v, o and q, fused
    gate_up, down, gate/up) gets >= 132 blocks; the splits of K cover each
    packed row exactly once, each 64-row step of a split lies in one scale
    group, and where K is split the workspace holds a slot for every
    block."""
    rps = t4.grid(in_, out, rows)
    kp, tiles = in_ // 2, -(-out // t4._BN)
    groups = 1 if rows == 1 else -(-rows // t4._ROWS_PER_BLOCK)
    splits = -(-kp // rps)
    assert rps in (16, 32) or rps % 64 == 0
    n_blocks = t4.blocks(in_, out, rows, rps)
    assert n_blocks == tiles * groups * splits >= 132
    covered = np.zeros(kp, np.int64)
    for s in range(splits):
        rows_of_split = np.arange(s * rps, min(kp, (s + 1) * rps))
        covered[rows_of_split] += 1
        step = min(rps, 64)  # the kernel's step through a split
        for row0 in range(s * rps, min(kp, (s + 1) * rps), step):
            assert row0 // 64 == (row0 + step - 1) // 64
    assert (covered == 1).all()
    assert splits == 1 or n_blocks <= t4._MAX_BLOCKS
    assert tiles * groups <= t4._COUNTERS


@pytest.mark.parametrize("bias_dtype", [np.float32, "bfloat16"])
def test_plain_bias_rounds_as_jax(bias_dtype):
    """The bias epilogue of the plain path (the kernel's function) equals
    JAX's `_linear` on an int4 leaf with a bias: bf16(f32(bf16 out) +
    f32(b)) as bagel_tpu/models/qwen2.py:_linear rounds it after its kernel,
    bit for bit wherever the unbiased outputs agree."""
    rng = np.random.default_rng(11)
    in_, out = 256, 512
    w = (rng.standard_normal((in_, out)) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, in_)).astype(np.float32)
    b = rng.standard_normal(out).astype(np.float32)
    leaf = dict(jquantize_int4(jnp.asarray(w), group=128))
    leaf["b"] = jnp.asarray(b, dtype=jnp.bfloat16 if bias_dtype == "bfloat16" else jnp.float32)
    tleaf = params_from_numpy({k: np.asarray(v) for k, v in leaf.items()}, "cpu")
    xb = jnp.asarray(x, dtype=jnp.bfloat16)
    # JAX's int4 branch on an eligible leaf: the kernel's bf16 out, then the bias in f32
    unbiased = j4.int4_matmul(xb, leaf["w_p4"], leaf["scale4"], interpret=True)
    want = np.asarray((unbiased.astype(jnp.float32) + leaf["b"].astype(jnp.float32))
                      .astype(jnp.bfloat16).astype(jnp.float32))
    plain = t4.int4_matmul_plain(torch.tensor(x), tleaf["w_p4"], tleaf["scale4"])
    got = t4.int4_matmul(torch.tensor(x), tleaf["w_p4"], tleaf["scale4"], tleaf["b"])
    assert got.dtype == torch.bfloat16
    same = plain.float().numpy() == np.asarray(unbiased.astype(jnp.float32))
    assert same.mean() > 0.99  # the unbiased products round alike almost everywhere
    np.testing.assert_array_equal(got.float().numpy()[same], want[same])


def test_wrapper_checks_refuse_what_the_kernel_does_not_take():
    """The checks the CUDA path runs before it passes pointers: uint8
    nibbles and f32 scales, matching shapes, at most 64 rows, contiguous
    16-byte-aligned weights, and a contiguous bf16 or f32 bias of the
    output's width."""
    leaf = quantize_weight_int4(torch.zeros((256, 512)))
    w, s = leaf["w_p4"], leaf["scale4"]
    x = torch.zeros((2, 256), dtype=torch.bfloat16)
    for bias in (None, torch.zeros(512, dtype=torch.bfloat16), torch.zeros(512)):
        t4._check(x, w, s, bias)  # accepted
    with pytest.raises(TypeError, match="uint8"):
        t4._check(x, w.to(torch.int8), s, None)
    with pytest.raises(ValueError, match="shapes"):
        t4._check(x, w, s[:1], None)
    with pytest.raises(ValueError, match="rows"):
        t4._check(torch.zeros((65, 256)), w, s, None)
    with pytest.raises(ValueError, match="contiguous"):
        t4._check(x, w.t().contiguous().t(), s, None)
    for bad in (torch.zeros(512, dtype=torch.float16), torch.zeros(256), torch.zeros(1024)[::2]):
        with pytest.raises(ValueError, match="bias"):
            t4._check(x, w, s, bad)
