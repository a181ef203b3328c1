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


@pytest.mark.parametrize("in_,out", [(3584, 4608), (3584, 512), (3584, 3584),
                                     (3584, 37888), (18944, 3584)])
def test_split_k_fills_the_card(in_, out):
    """Every decode linear of the MoT gets >= 132 blocks and covers each
    slice of 8 packed rows exactly once."""
    per, splits = t4.split_k(in_, out)
    tiles = -(-out // 512)
    assert tiles * splits >= 132
    assert (splits - 1) * per < in_ // 16 <= splits * per
