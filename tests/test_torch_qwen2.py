"""bagel_tpu_torch llm_extend vs bagel_tpu llm_extend (CPU, fp32).

Every parameter leaf is numpy-random (gen expert != und expert, norms != 1),
so a swapped expert slice or a dropped norm cannot pass. Bar: 1e-4 on the
hidden states and the written K/V.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_qwen2
from bagel_tpu.models import qwen2 as jq
from bagel_tpu_torch.models import qwen2 as tq
from bagel_tpu_torch.utils.bridge import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)


def randomized(params, seed):
    """Numpy copy of a JAX parameter tree with every leaf perturbed by noise
    of its own scale (0.05 where the leaf is constant: biases, norms, the
    zero-initialized llm2vae)."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        x = np.asarray(x, np.float32)
        s = float(x.std()) or 0.05
        return (x + s * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree.map(leaf, params)


def _cache_np(cache):
    return np.asarray(cache.k), np.asarray(cache.v), np.asarray(cache.length)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("layer_module", ["dense", "moe", "mot"])
def test_llm_extend_matches_jax(layer_module, fused):
    cfg = tiny_qwen2(layer_module=layer_module)
    tree = randomized(jq.init_qwen2_params(jax.random.PRNGKey(0), cfg, jnp.float32), 1)
    if fused:
        tree = jax.tree.map(np.asarray, jq.fuse_llm_params(jax.tree.map(jnp.asarray, tree)))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, "cpu")
    rng = np.random.default_rng(2)
    b, s, d = 2, 64, cfg.hidden_size

    jcache = jq.kv_cache_init(cfg, b, s, jnp.float32)
    tcache = tq.kv_cache_init(cfg, b, s, torch.float32, device="cpu")

    def step(x, pos, valid, und_len, causal, update_cache):
        nonlocal jcache, tcache
        with jax.default_matmul_precision("float32"):
            jh, jc = jq.llm_extend(
                jp, cfg, jnp.asarray(x), jnp.asarray(pos), jcache, jnp.asarray(valid),
                und_len=und_len, causal=causal, update_cache=update_cache,
                precision="float32")
        th, tc = tq.llm_extend(
            tp, cfg, torch.tensor(x), torch.tensor(pos), tcache, torch.tensor(valid),
            und_len=und_len, causal=causal, update_cache=update_cache)
        rows = np.arange(x.shape[1])[None, :] < valid[:, None]
        np.testing.assert_allclose(th.numpy()[rows], np.asarray(jh)[rows], **TOL)
        for got, want in zip(_cache_np(tc), _cache_np(jc)):
            np.testing.assert_allclose(got, want, **TOL)
        if update_cache:
            jcache, tcache = jc, tc
        else:
            assert tc is tcache

    # causal prefill, padded and ragged across rows
    t = 16
    valid = np.asarray([13, 9], np.int32)
    pos = np.zeros((b, t), np.int32)
    for r in range(b):
        pos[r, : valid[r]] = np.arange(valid[r])
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    step(x, pos, valid, und_len=t, causal=True, update_cache=True)

    # a non-causal gen block [start, end, latents...]: und_len=2, one rope id
    t = 10
    valid = np.full((b,), t, np.int32)
    pos = np.broadcast_to(np.asarray([13, 9], np.int32)[:, None], (b, t)).copy()
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    step(x, pos, valid, und_len=2, causal=False, update_cache=False)
    step(x, pos, valid, und_len=2, causal=False, update_cache=True)


def test_embed_and_logits_match_jax():
    cfg = tiny_qwen2()
    tree = randomized(jq.init_qwen2_params(jax.random.PRNGKey(0), cfg, jnp.float32), 3)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, "cpu")
    ids = np.asarray([[1, 5, 7, 511]], np.int32)
    np.testing.assert_array_equal(
        tq.embed_tokens(tp, torch.tensor(ids)).numpy(),
        np.asarray(jq.embed_tokens(jp, jnp.asarray(ids))))
    h = np.random.default_rng(4).standard_normal((1, 3, cfg.hidden_size)).astype(np.float32)
    np.testing.assert_allclose(
        tq.lm_logits(tp, torch.tensor(h)).numpy(),
        np.asarray(jq.lm_logits(jp, jnp.asarray(h), precision="float32")), **TOL)


def test_cache_overflow_raises():
    cfg = tiny_qwen2()
    tp = params_from_numpy(
        jax.tree.map(np.asarray, jq.init_qwen2_params(jax.random.PRNGKey(0), cfg, jnp.float32)),
        "cpu")
    cache = tq.kv_cache_init(cfg, 1, 8, torch.float32, device="cpu")
    x = torch.zeros(1, 9, cfg.hidden_size)
    with pytest.raises(ValueError, match="KV buffer too small"):
        tq.llm_extend(tp, cfg, x, torch.zeros(1, 9, dtype=torch.int32), cache,
                      torch.tensor([9]), und_len=9, causal=True, update_cache=True)


def test_later_slice_features_raise():
    """The features of later slices take their inputs: the int8 KV cache
    (tests/test_torch_kv_quant.py) and quantized weight leaves
    (tests/test_torch_quant.py). Sharded inference, the --mesh that raised
    here, is held in tests/test_torch_sharded_inference.py."""
    cfg = tiny_qwen2()
    cache = tq.kv_cache_init(cfg, 1, 8, torch.int8, device="cpu")
    assert cache.k.dtype == torch.int8 and cache.k_scale.shape == (cfg.num_hidden_layers, 1, 8,
                                                                   cfg.num_key_value_heads)
    leaf = {"w_q": torch.full((4, 3), 2, dtype=torch.int8), "scale": torch.ones(3)}
    assert torch.equal(tq._linear(torch.ones(2, 4), leaf), torch.full((2, 3), 8.0))
