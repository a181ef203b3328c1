"""bagel_tpu_torch.utils.quant and the quantized leaves of the port's qwen2
vs bagel_tpu's (CPU).

Bars: codes and scales identical to JAX's on the same f32 weights, in all
four modes, stacked and per layer; `_linear` over each leaf kind, and
`embed_tokens` / `lm_logits`, within 1e-5 of JAX's in f32 (w8a8: the int32
sums are exact, so only the f32 epilogue's last bit may differ: 1e-6
relative); fused leaves equal to JAX's bit for bit; the bridge keeps scales
f32 under a dtype cast.
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
from bagel_tpu_torch.utils import quant as tquant
from bagel_tpu_torch.utils.bridge import params_from_numpy

from test_torch_qwen2 import randomized

MODES = ["int8", "w8a8", "int4", "nf4"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t_tree(tree):
    return jax.tree.map(lambda t: t.numpy(), tree,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))


def _assert_trees_equal(got, want):
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert g.dtype == w.dtype, (jax.tree_util.keystr(path), g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


def _weights(seed, shape, outliers=True):
    """Normal weights with a few large values and some exact ties of the
    rounding (halves), so that round-half-to-even is exercised."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    if outliers:
        flat = w.reshape(-1)
        flat[rng.integers(0, flat.size, 8)] *= 25.0
    return w


_QUANTIZERS = {
    "int8": (jquant.quantize_weight, tquant.quantize_weight),
    "int4": (jquant.quantize_weight_int4, tquant.quantize_weight_int4),
    "nf4": (jquant.quantize_weight_nf4, tquant.quantize_weight_nf4),
}


@pytest.mark.parametrize("kind", sorted(_QUANTIZERS))
@pytest.mark.parametrize("shape", [(256, 96), (3, 384, 64), (64, 40)])
def test_quantize_codes_identical(kind, shape):
    jfn, tfn = _QUANTIZERS[kind]
    w = _weights(0, shape)
    want = _np_tree(jfn(jnp.asarray(w)))
    got = _t_tree(tfn(torch.tensor(w)))
    _assert_trees_equal(got, want)


def test_round_half_to_even():
    """Scales chosen so that w / scale lands on exact halves."""
    w = np.zeros((4, 3), np.float32)
    w[:, 0] = [127.0, 0.5, 1.5, -2.5]  # scale 1: codes 127, 0, 2, -2
    w[:, 1] = [7.0, 0.5, 2.5, -3.5]
    w[:, 2] = [1.0, -1.0, 0.25, 0.75]
    for jfn, tfn in (_QUANTIZERS["int8"], _QUANTIZERS["int4"]):
        _assert_trees_equal(_t_tree(tfn(torch.tensor(w))), _np_tree(jfn(jnp.asarray(w))))
    got = tquant.quantize_weight(torch.tensor(w))["w_q"][:, 0].tolist()
    assert got == [127, 0, 2, -2]


def test_dequantize_weight_and_passthrough_match_jax():
    w = _weights(11, (2, 128, 40))
    jleaf, tleaf = jquant.quantize_weight(jnp.asarray(w)), tquant.quantize_weight(torch.tensor(w))
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jquant.dequantize_weight(jleaf, jd)).astype(np.float32)
        np.testing.assert_array_equal(tquant.dequantize_weight(tleaf, td).float().numpy(), want)
        got = tquant.maybe_dequantize(tleaf, td).float().numpy()
        np.testing.assert_array_equal(got, want)
    plain = torch.ones(3)
    assert tquant.maybe_dequantize(plain) is plain


@pytest.mark.parametrize("kind", ["int4", "nf4"])
def test_dequantize_weight4_matches_jax(kind):
    jfn, tfn = _QUANTIZERS[kind]
    w = _weights(1, (2, 256, 48))
    jleaf, tleaf = jfn(jnp.asarray(w)), tfn(torch.tensor(w))
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jquant.dequantize_weight4(jleaf, jd)).astype(np.float32)
        got = tquant.dequantize_weight4(tleaf, td).float().numpy()
        np.testing.assert_array_equal(got, want)


def test_nibble_pack_roundtrip():
    idx = torch.randint(0, 16, (3, 10, 7), generator=torch.Generator().manual_seed(0),
                        dtype=torch.uint8)
    packed = tquant._pack_nibbles(idx)
    assert packed.shape == (3, 5, 7) and packed.dtype == torch.uint8
    assert torch.equal(tquant._unpack_nibbles(packed), idx)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jquant._pack_nibbles(jnp.asarray(idx.numpy()))))


@pytest.mark.parametrize("mode", MODES)
def test_quantize_llm_params_identical(mode):
    cfg = tiny_qwen2(layer_module="mot")
    tree = randomized(jq.init_qwen2_params(jax.random.PRNGKey(0), cfg, jnp.float32), 3)
    want = _np_tree(jquant.quantize_llm_params(jax.tree.map(jnp.asarray, tree), mode))
    got = _t_tree(tquant.quantize_llm_params(params_from_numpy(tree, "cpu"), mode))
    _assert_trees_equal(got, want)


def test_quantize_bagel_params_leaves_the_input_tree():
    cfg = tiny_qwen2()
    tree = params_from_numpy(_np_tree(jq.init_qwen2_params(jax.random.PRNGKey(0), cfg,
                                                           jnp.float32)), "cpu")
    params = {"llm": tree, "other": torch.ones(3)}
    q = tquant.quantize_bagel_params(params, "int4")
    assert "w" in params["llm"]["layers"]["attn"]["q"]  # the input is untouched
    assert set(q["llm"]["layers"]["attn"]["q"]) == {"w_p4", "scale4", "b"}
    assert q["other"] is params["other"]
    assert set(q["llm"]["embed"]) == {"w_q", "row_scale"}
    assert set(q["llm"]["lm_head"]) == {"w_q", "scale"}


def _leaf(kind, seed, d_in, d_out, bias):
    w = _weights(seed, (d_in, d_out), outliers=False)
    j = {"w": jnp.asarray(w)}
    if kind == "w8a8":
        q = jquant.quantize_weight(j["w"])
        j = {"w_q8": q["w_q"], "scale": q["scale"]}
    elif kind != "plain":
        j = {"int8": jquant.quantize_weight, "int4": jquant.quantize_weight_int4,
             "nf4": jquant.quantize_weight_nf4}[kind](j["w"])
    if bias:
        j["b"] = jnp.asarray(np.random.default_rng(seed + 1).standard_normal(d_out)
                             .astype(np.float32) * 0.1)
    return j, params_from_numpy(_np_tree(j), "cpu")


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("kind", ["plain"] + MODES)
def test_linear_leaf_matches_jax(kind, bias):
    jleaf, tleaf = _leaf(kind, 4, 256, 96, bias)
    x = np.random.default_rng(5).standard_normal((2, 7, 256)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jq._linear(jnp.asarray(x), jleaf, precision="float32"))
    got = tq._linear(torch.tensor(x), tleaf).numpy()
    assert got.shape == want.shape == (2, 7, 96)
    if kind == "w8a8":  # exact int32 sums; the f32 epilogue may differ in its last bit
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def test_w8a8_linear_exact_without_bias():
    """Without a bias the w8a8 product is the int32 sums times two scales:
    the port's and JAX's agree bit for bit."""
    jleaf, tleaf = _leaf("w8a8", 6, 384, 64, False)
    x = np.random.default_rng(7).standard_normal((5, 384)).astype(np.float32)
    want = np.asarray(jq._linear(jnp.asarray(x), jleaf))
    got = tq._linear(torch.tensor(x), tleaf).numpy()
    np.testing.assert_array_equal(got, want)


def test_embed_and_logits_quantized_match_jax():
    cfg = tiny_qwen2()
    tree = randomized(jq.init_qwen2_params(jax.random.PRNGKey(1), cfg, jnp.float32), 8)
    jp = jquant.quantize_llm_params(jax.tree.map(jnp.asarray, tree), "int8")
    tp = tquant.quantize_llm_params(params_from_numpy(tree, "cpu"), "int8")
    ids = np.asarray([[0, 5, 17], [cfg.vocab_size - 1, 3, 3]], np.int32)
    want = np.asarray(jq.embed_tokens(jp, jnp.asarray(ids))).astype(np.float32)
    got = tq.embed_tokens(tp, torch.tensor(ids, dtype=torch.long))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    h = np.random.default_rng(9).standard_normal((3, cfg.hidden_size)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jq.lm_logits(jp, jnp.asarray(h), precision="float32"))
    got = tq.lm_logits(tp, torch.tensor(h)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", [None] + MODES)
def test_fuse_llm_params_matches_jax(mode):
    cfg = tiny_qwen2(layer_module="mot")
    tree = randomized(jq.init_qwen2_params(jax.random.PRNGKey(2), cfg, jnp.float32), 10)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, "cpu")
    if mode:
        jp, tp = jquant.quantize_llm_params(jp, mode), tquant.quantize_llm_params(tp, mode)
    want = _np_tree(jq.fuse_llm_params(jp))
    got = tq.fuse_llm_params(tp)
    _assert_trees_equal(_t_tree(got), want)
    assert "q" in tp["layers"]["attn"]  # not in place: the input keeps its leaves
    again = tq.fuse_llm_params(got, inplace=True)  # idempotent
    _assert_trees_equal(_t_tree(again), want)


def test_bridge_keeps_scales_f32():
    tree = {"a": {"w_q": np.ones((4, 2), np.int8), "scale": np.full(2, 0.3, np.float32),
                  "b": np.ones(2, np.float32)},
            "p": {"w_p4": np.ones((2, 2), np.uint8), "scale4": np.ones((1, 2), np.float32)},
            "n": {"w_nf4": np.ones((2, 2), np.uint8), "absmax": np.ones((1, 2), np.float32)},
            "e": {"w_q": np.ones((3, 2), np.int8), "row_scale": np.ones(3, np.float32)},
            "w": np.ones((2, 2), np.float32)}
    got = params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    for leaf, key in (("a", "scale"), ("p", "scale4"), ("n", "absmax"), ("e", "row_scale")):
        assert got[leaf][key].dtype == torch.float32, (leaf, key)
    assert got["a"]["scale"][0].item() == np.float32(0.3)
    assert got["a"]["b"].dtype == torch.bfloat16 and got["w"].dtype == torch.bfloat16
    assert got["a"]["w_q"].dtype == torch.int8 and got["p"]["w_p4"].dtype == torch.uint8
