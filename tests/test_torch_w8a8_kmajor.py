"""The w8a8 path's layout and activation quantization vs bagel_tpu.

- `quantize_rows_plain` (the plain twin of the CUDA quantization pass) is
  bit-identical to the JAX package's per-token quantization in its w8a8
  `_linear` (bagel_tpu/models/qwen2.py), on zero rows, exact +-absmax and
  ties at .5 (round half to even).
- With the whole row's scale given, each tp slice of a row quantizes to
  the slice of the whole row's codes, bit for bit; the whole row's scale is
  `row_scale` of the slices' absmax maxed (what a row-parallel w8a8 leaf
  all-reduces).
- `utils.quant.w8a8_kmajor` lays w8a8 weights out k-major (what B5's wgmma
  reads) without changing codes, scales or shapes; it is idempotent and
  composes with `fuse_llm_params`; `_linear` over a k-major and a row-major
  leaf agrees bit for bit, and with JAX's.
- B5's wrapper refuses a row-major weight for the CUDA path before any
  kernel is built.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_qwen2
from bagel_tpu.models import qwen2 as jq
from bagel_tpu.utils import quant as jquant
from bagel_tpu_torch.models import qwen2 as tq
from bagel_tpu_torch.ops import int8_matmul as t8
from bagel_tpu_torch.utils import quant as tquant
from bagel_tpu_torch.utils.bridge import params_from_numpy

from test_torch_qwen2 import randomized


def _jax_quantize_rows(x):
    """The three lines of bagel_tpu/models/qwen2.py:_linear's w8a8 branch."""
    xf = jnp.asarray(x).astype(jnp.float32)
    xs = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12) / 127.0
    xq = jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8)
    return np.asarray(xq), np.asarray(xs)


def _rows(kind):
    rng = np.random.default_rng(0)
    if kind == "zero row":
        x = rng.standard_normal((3, 64)).astype(np.float32)
        x[1] = 0.0
    elif kind == "exact absmax":  # codes of +-absmax are exactly +-127
        x = np.clip(rng.standard_normal((4, 96)), -2.5, 2.5).astype(np.float32)
        x[0, 5], x[1, 7], x[2, 3], x[2, 9] = 3.0, -3.0, 3.0, -3.0
    elif kind == "ties at .5":  # absmax 127: scale 1, codes of k + .5 round to even
        x = np.zeros((2, 32), np.float32)
        x[:, 0] = 127.0
        x[0, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
        x[1, 1:5] = [3.5, -3.5, 4.5, -4.5]
    else:  # bf16 activations of mixed magnitude, as the card sees them
        x = (rng.standard_normal((7, 128)) * rng.uniform(0.01, 50, (7, 1))).astype(np.float32)
        x = torch.tensor(x).bfloat16().float().numpy()
    return x


@pytest.mark.parametrize("kind", ["zero row", "exact absmax", "ties at .5", "bf16 rows"])
def test_quantize_rows_plain_equals_jax(kind):
    x = _rows(kind)
    want_q, want_s = _jax_quantize_rows(x)
    got_q, got_s = t8.quantize_rows_plain(torch.tensor(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    if kind == "ties at .5":
        assert got_q[0, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]
        assert got_q[1, 1:5].tolist() == [4, -4, 4, -4]
    if kind == "zero row":
        assert got_q[1].abs().max().item() == 0 and got_s[1].item() == np.float32(1e-12) / 127
    # on a CPU tensor the wrapper is the plain version and launches nothing
    q2, s2 = t8.quantize_rows(torch.tensor(x))
    assert torch.equal(q2, got_q) and torch.equal(s2, got_s)
    assert t8.quantize_rows.launches == 0


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["zero row", "exact absmax", "ties at .5", "bf16 rows"])
def test_given_scale_slices_equal_the_whole_rows(kind, n):
    x = torch.tensor(_rows(kind))
    whole_q, whole_s = t8.quantize_rows_plain(x)
    slices = x.chunk(n, dim=-1)
    amax = torch.stack([t8.row_absmax(part) for part in slices]).amax(dim=0)
    scale = t8.row_scale(amax)
    assert torch.equal(scale, whole_s)
    for i, part in enumerate(slices):
        q, s = t8.quantize_rows(part, scale)
        assert s is scale and torch.equal(q, whole_q.chunk(n, dim=-1)[i])
    if kind == "bf16 rows":  # each slice's own scale is another quantization
        own = torch.cat([t8.quantize_rows_plain(part)[0] for part in slices], dim=-1)
        assert not torch.equal(own, whole_q)
    assert t8.quantize_rows_given.launches == t8.row_absmax.launches == 0


def test_quantize_rows_checks_refuse_what_the_kernel_does_not_take():
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    t8._check_rows(x)  # accepted
    with pytest.raises(TypeError, match="bf16"):
        t8._check_rows(x.float())
    with pytest.raises(ValueError, match="multiple of 8"):
        t8._check_rows(x[:, :60])
    with pytest.raises(ValueError, match="16-byte"):
        t8._check_rows(torch.zeros((4, 72), dtype=torch.bfloat16)[:, 4:68])


@pytest.mark.parametrize("shape", [(256, 96), (3, 384, 64)])
def test_kmajor_keeps_codes_scales_and_shapes(shape):
    w = torch.tensor(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    q = tquant._quantize_weight_a8(w)
    row = {k: v.clone() for k, v in q.items()}
    tree = {"layer": q}
    assert tquant.w8a8_kmajor(tree) is tree
    w8 = tree["layer"]["w_q8"]
    assert tquant.is_kmajor(w8) and not tquant.is_kmajor(row["w_q8"])
    assert w8.shape == row["w_q8"].shape and w8.stride()[-2:] == (1, shape[-2])
    assert torch.equal(w8, row["w_q8"]) and torch.equal(tree["layer"]["scale"], row["scale"])
    assert tree["layer"]["scale"].is_contiguous()  # only the weight moves
    assert tquant.w8a8_kmajor(tree)["layer"]["w_q8"] is w8  # idempotent: no copy


@pytest.mark.parametrize("bias", [False, True])
def test_linear_over_kmajor_and_row_major_leaves(bias):
    """Bit-identical on the CPU, and as JAX's w8a8 `_linear` (bit for bit
    without a bias; the f32 epilogue's last bit with one, as
    test_torch_quant.py holds it)."""
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((384, 96)) * 0.02).astype(np.float32)
    q = jquant.quantize_weight(jnp.asarray(w))
    jleaf = {"w_q8": q["w_q"], "scale": q["scale"]}
    if bias:
        jleaf["b"] = jnp.asarray(rng.standard_normal(96).astype(np.float32) * 0.1)
    row = params_from_numpy(jax.tree.map(np.asarray, jleaf), "cpu")
    kmaj = tquant.w8a8_kmajor(dict(row))
    assert tquant.is_kmajor(kmaj["w_q8"])
    x = rng.standard_normal((2, 5, 384)).astype(np.float32)
    got_row = tq._linear(torch.tensor(x), row)
    got_k = tq._linear(torch.tensor(x), kmaj)
    assert torch.equal(got_row, got_k)
    want = np.asarray(jq._linear(jnp.asarray(x), jleaf))
    if bias:
        np.testing.assert_allclose(got_k.numpy(), want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got_k.numpy(), want)


def _w8a8_tree():
    cfg = tiny_qwen2(layer_module="mot")
    tree = randomized(jq.init_qwen2_params(jax.random.PRNGKey(3), cfg, jnp.float32), 11)
    return tquant.quantize_llm_params(params_from_numpy(tree, "cpu"), "w8a8")


def _w8_leaves(tree, path=""):
    for k, v in tree.items():
        if k == "w_q8":
            yield path, v
        elif isinstance(v, dict):
            yield from _w8_leaves(v, f"{path}/{k}")


def test_kmajor_composes_with_fusion():
    """k-major then fused, and fused then k-major: the same values, every
    w8a8 leaf k-major either way, and the same as the row-major fusion."""
    plain = tq.fuse_llm_params(_w8a8_tree())
    before = tq.fuse_llm_params(tquant.w8a8_kmajor(_w8a8_tree()))
    after = tquant.w8a8_kmajor(tq.fuse_llm_params(_w8a8_tree()))
    want = dict(_w8_leaves(plain))
    assert "/layers/attn/qkv" in want and "/layers/mlp_gen/gate_up" in want
    for tree in (before, after):
        got = dict(_w8_leaves(tree))
        assert got.keys() == want.keys()
        for path, w in got.items():
            assert tquant.is_kmajor(w), path
            assert torch.equal(w, want[path]), path
    again = tquant.w8a8_kmajor(tq.fuse_llm_params(after, inplace=True))
    assert all(a is b for (_, a), (_, b) in zip(_w8_leaves(again), _w8_leaves(after)))


def test_b5_wrapper_refuses_a_row_major_weight_before_launch():
    """On the CUDA path the wrapper names the helper instead of transposing
    per call; its checks run before any kernel is built (no nvcc here)."""
    rng = np.random.default_rng(5)
    xq = torch.tensor(rng.integers(-127, 128, (4, 64)).astype(np.int8))
    wq = torch.tensor(rng.integers(-127, 128, (64, 32)).astype(np.int8))
    xs, ws = torch.ones((4, 1)), torch.ones(32)
    with pytest.raises(ValueError, match="w8a8_kmajor"):
        t8._check(xq, xs, wq, ws, None, torch.bfloat16)
    t8._check(xq, xs, tquant.to_kmajor(wq), ws, None, torch.bfloat16)
    # the plain version takes either layout
    assert torch.equal(t8.int8_matmul(xq, xs, wq, ws),
                       t8.int8_matmul(xq, xs, tquant.to_kmajor(wq), ws))
