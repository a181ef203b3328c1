"""The int8 KV cache: bagel_tpu_torch vs bagel_tpu (CPU, fp32 weights; the
int8 cache makes the attention's working dtype bf16 on both sides).

Bars: `_kv_quantize`'s codes and scales bit for bit; `llm_extend` over an
int8 cache within 1e-4 on the hidden states, with at most 1% of the written
codes one step off (a K/V that lands within float noise of a rounding
boundary) and none further; `decode_text` with an `active` mask giving
JAX's tokens; B1-kv8's plain twin equal to dequantize + the plain attention,
with NaN scales and random codes past every row's live end.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_qwen2
from bagel_tpu.models import qwen2 as jq
from bagel_tpu_torch.models import qwen2 as tq
from bagel_tpu_torch.ops import flash
from bagel_tpu_torch.utils.bridge import params_from_numpy

from test_torch_qwen2 import randomized
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_qwen2(layer_module="mot")
    tree = randomized(jq.init_qwen2_params(jax.random.PRNGKey(0), cfg, jnp.float32), 5)
    tree["lm_head"]["w"] = tree["lm_head"]["w"] * 8.0  # sharp logits: no near ties
    return cfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("shape", [(2, 16, 4, 32), (3, 5, 2, 128)])
def test_kv_quantize_bit_exact(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0  # an all-zero vector: the 1e-12 floor of the scale
    x[0, 1, 0, :4] = [127.0, -63.5, 0.5, -0.5]  # halves: round half to even
    jcodes, jscale = jq._kv_quantize(jnp.asarray(x))
    tcodes, tscale = tq._kv_quantize(torch.tensor(x))
    assert tcodes.dtype == torch.int8 and tscale.dtype == torch.float32
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        tq._kv_dequantize(tcodes, tscale, torch.bfloat16).float().numpy(),
        np.asarray(jq._kv_dequantize(jcodes, jscale, jnp.bfloat16), np.float32))


def test_kv_cache_init_int8(model):
    cfg, _, _ = model
    cache = tq.kv_cache_init(cfg, 2, 32, torch.int8, device="cpu")
    assert cache.k.dtype == torch.int8 and cache.k_scale.shape == cache.k.shape[:-1]
    assert cache.v_scale.dtype == torch.float32 and cache.batch == 2
    plain = tq.kv_cache_init(cfg, 2, 32, torch.float32, device="cpu")
    assert plain.k_scale is None and plain.v_scale is None


def _codes_close(got, want):
    """At most 1% of the codes one step off, none further."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (diff.max(), (diff > 0).mean())


def test_llm_extend_int8_cache_matches_jax(model):
    """A ragged 2-row prefill, a non-causal block and three decode steps,
    all through the int8 cache."""
    cfg, jp, tp = model
    rng = np.random.default_rng(2)
    b, d = 2, cfg.hidden_size
    jcache = jq.kv_cache_init(cfg, b, 64, jnp.int8)
    tcache = tq.kv_cache_init(cfg, b, 64, torch.int8, device="cpu")
    steps = [(10, [10, 7], True), (6, [6, 0], False), (1, [1, 1], True), (1, [0, 1], True),
             (1, [1, 1], True)]
    rope = np.zeros(b, np.int32)
    for t, valid, causal in steps:
        x = rng.standard_normal((b, t, d)).astype(np.float32)
        pos = rope[:, None] + np.arange(t)[None]
        with jax.default_matmul_precision("float32"):
            jh, jcache = jq.llm_extend(jp, cfg, jnp.asarray(x), jnp.asarray(pos), jcache,
                                       jnp.asarray(valid), und_len=t, causal=causal,
                                       update_cache=True, precision="float32")
        th, tcache = tq.llm_extend(tp, cfg, torch.tensor(x), torch.tensor(pos), tcache,
                                   torch.tensor(valid), und_len=t, causal=causal,
                                   update_cache=True)
        for row, n in enumerate(valid):
            np.testing.assert_allclose(th[row, :n].numpy(), np.asarray(jh)[row, :n], **TOL)
        rope = rope + np.asarray(valid)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))
    for row, n in enumerate(np.asarray(jcache.length)):
        _codes_close(tcache.k[:, row, :n].numpy(), np.asarray(jcache.k)[:, row, :n])
        _codes_close(tcache.v[:, row, :n].numpy(), np.asarray(jcache.v)[:, row, :n])
        np.testing.assert_allclose(tcache.k_scale[:, row, :n].numpy(),
                                   np.asarray(jcache.k_scale)[:, row, :n], **TOL)
        np.testing.assert_allclose(tcache.v_scale[:, row, :n].numpy(),
                                   np.asarray(jcache.v_scale)[:, row, :n], **TOL)


@pytest.mark.parametrize("active", [None, [True, False, True]])
def test_decode_text_int8_matches_jax(model, active):
    cfg, jp, tp = model
    b, t = 3, 7
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, t))
    valid = [7, 4, 6]
    pos = np.broadcast_to(np.arange(t)[None], (b, t))

    with jax.default_matmul_precision("float32"):
        jcache = jq.kv_cache_init(cfg, b, 32, jnp.int8)
        _, jcache = jq.llm_extend(jp, cfg, jq.embed_tokens(jp, jnp.asarray(ids)),
                                  jnp.asarray(pos), jcache, jnp.asarray(valid), und_len=t,
                                  causal=True, update_cache=True, precision="float32")
        jtoks, jout = jq.decode_text(
            jp, cfg, jcache, jnp.asarray([1, 2, 3]), jnp.asarray(valid), max_steps=6, eos_id=0,
            precision="float32", active=None if active is None else jnp.asarray(active))
    tcache = tq.kv_cache_init(cfg, b, 32, torch.int8, device="cpu")
    _, tcache = tq.llm_extend(tp, cfg, tq.embed_tokens(tp, torch.tensor(ids)), torch.tensor(pos),
                              tcache, torch.tensor(valid), und_len=t, causal=True,
                              update_cache=True)
    ttoks, tout = tq.decode_text(
        tp, cfg, tcache, torch.tensor([1, 2, 3]), torch.tensor(valid, dtype=torch.int32),
        max_steps=6, eos_id=0, active=None if active is None else torch.tensor(active),
        in_place=True)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tout.length.numpy(), np.asarray(jout.length))
    assert tout.k is tcache.k  # in place: the given buffers, no copy
    if active is not None:
        assert int(tout.length[1]) == valid[1]  # a frozen row never advances


def test_decode_text_leaves_an_unowned_cache(model):
    cfg, _, tp = model
    cache = tq.kv_cache_init(cfg, 1, 16, torch.int8, device="cpu")
    before = [t.clone() for t in cache.buffers()]
    _, out = tq.decode_text(tp, cfg, cache, torch.tensor([1]), torch.tensor([0]),
                            max_steps=3, eos_id=0)
    assert out.k is not cache.k and int(out.length[0]) > 0
    assert all(torch.equal(a, b) for a, b in zip(before, cache.buffers()))


def _kv8_inputs(seed, b=3, s=320, kh=2, h=8, d=128):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, 1, h, d), generator=g).bfloat16()
    k8 = torch.randint(-127, 128, (b, s, kh, d), generator=g, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (b, s, kh, d), generator=g, dtype=torch.int8)
    ks = torch.rand((b, s, kh), generator=g) * 0.05
    vs = torch.rand((b, s, kh), generator=g) * 0.05
    return q, k8, v8, ks, vs


@pytest.mark.parametrize("splits", [None, 1, 3])
def test_kv8_plain_twin_is_dequantize_plus_plain_attention(splits):
    q, k8, v8, ks, vs = _kv8_inputs(4)
    past = torch.tensor([10, 200, 318], dtype=torch.int32)
    valid = torch.tensor([1, 1, 0], dtype=torch.int32)
    want_k = flash.kv_dequantize(k8, ks)
    want_v = flash.kv_dequantize(v8, vs)
    want = (flash.flash_cached_attention_plain(q, want_k, want_v, past, valid, causal=True)
            if splits is None else
            flash.flash_decode_split_plain(q, want_k, want_v, past, valid, splits=splits))
    for row, p in enumerate(past.tolist()):  # stale state past every live end
        ks[row, p + 1:] = float("nan")
        vs[row, p + 1:] = float("nan")
        k8[row, p + 1:] = torch.randint(-127, 128, k8[row, p + 1:].shape, dtype=torch.int8)
    ks[2] = float("nan")  # a row with q_valid = 0 reads no key
    if splits is None:  # the plain twin, and the wrapper on a CPU tensor
        got = flash.flash_decode_kv8_plain(q, k8, v8, ks, vs, past, valid)
        assert torch.equal(flash.flash_decode_kv8(q, k8, v8, ks, vs, past, valid), got)
    else:  # the split pair's arithmetic over the same live view
        got = flash.flash_decode_split_plain(q, *flash.kv8_live(k8, v8, ks, vs, past, valid),
                                             past, valid, splits=splits)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert got[2].abs().max() == 0


def test_kv8_plain_twin_matches_jax_dequantized_attention():
    """The decode step's attention as the JAX package computes it over an
    int8 cache (dequantize, masked attention with bf16 inputs)."""
    from bagel_tpu.ops.attention import cache_block_mask, dot_attention

    q, k8, v8, ks, vs = _kv8_inputs(5, b=2, s=96, kh=2, h=4)
    past = torch.tensor([40, 95], dtype=torch.int32)
    valid = torch.tensor([1, 1], dtype=torch.int32)
    jk = jq._kv_dequantize(jnp.asarray(k8.numpy()), jnp.asarray(ks.numpy()), jnp.bfloat16)
    jv = jq._kv_dequantize(jnp.asarray(v8.numpy()), jnp.asarray(vs.numpy()), jnp.bfloat16)
    jqry = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)
    mask = cache_block_mask(96, 1, jnp.asarray(past.numpy()), jnp.asarray(valid.numpy()), True)
    want = dot_attention(jqry, jk, jv, mask=mask, precision="float32")
    got = flash.flash_decode_kv8_plain(q, k8, v8, ks, vs, past, valid)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2**-7, atol=1e-3)  # one bf16 ulp
