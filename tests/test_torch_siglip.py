"""bagel_tpu_torch SigLIP tower and ViT adapters vs bagel_tpu (CPU, fp32).

Same numpy inputs and weights on both sides (every leaf perturbed, so
LayerNorms differ from 1/0 and the biases from 0). Bars: 2-D RoPE 1e-5,
masks exact, the tower and encode_vit_tokens 1e-4 against JAX's dense path
and its Pallas flash path in interpret mode.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_bagel
from bagel_tpu.models import bagel as jbagel
from bagel_tpu.models import siglip as jsiglip
from bagel_tpu.ops import attention as jattn
from bagel_tpu.ops import rope as jrope
from bagel_tpu_torch.models import bagel as tbagel
from bagel_tpu_torch.models import siglip as tsiglip
from bagel_tpu_torch.ops import attention as tattn
from bagel_tpu_torch.ops import rope as trope
from bagel_tpu_torch.utils.bridge import params_from_numpy

from test_torch_qwen2 import randomized
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

TOL = dict(rtol=1e-4, atol=1e-4)


def test_rope_2d_matches_jax():
    rng = np.random.default_rng(0)
    tabs_t = trope.rope_2d_tables(36, 7, 5)
    tabs_j = jrope.rope_2d_tables(36, 7, 5)
    for t, j in zip(tabs_t, tabs_j):
        assert tuple(t.shape) == (35, 36)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
    pos = rng.integers(0, 35, 11)
    q = rng.standard_normal((11, 3, 72)).astype(np.float32)
    k = rng.standard_normal((11, 3, 72)).astype(np.float32)
    got = trope.apply_rope_2d(torch.tensor(q), torch.tensor(k),
                              *(t[torch.tensor(pos)] for t in tabs_t))
    want = jrope.apply_rope_2d(jnp.asarray(q), jnp.asarray(k),
                               *(t[jnp.asarray(pos)] for t in tabs_j))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_masks_match_jax():
    rng = np.random.default_rng(1)
    seg = rng.integers(0, 3, (2, 40)).astype(np.int32)
    np.testing.assert_array_equal(tattn.segment_mask(torch.tensor(seg)).numpy(),
                                  np.asarray(jattn.segment_mask(jnp.asarray(seg))))
    doc = np.repeat(np.arange(4, dtype=np.int32), 10)  # doc 0 = padding
    fan = rng.integers(-1, 3, 40).astype(np.int32)
    noi = np.where(rng.random(40) < 0.4, fan, -1).astype(np.int32)
    np.testing.assert_array_equal(
        tattn.train_packed_mask(*(torch.tensor(x) for x in (doc, fan, noi))).numpy(),
        np.asarray(jattn.train_packed_mask(*(jnp.asarray(x) for x in (doc, fan, noi)))))


@pytest.fixture(scope="module")
def tower():
    """tiny_bagel's ViT + connector, randomized; two packed images (18 and
    12 patches) and 6 padding tokens."""
    cfg = tiny_bagel()
    tree = randomized(jbagel.init_bagel_params(jax.random.PRNGKey(0), cfg, jnp.float32), 5)
    tree = {k: tree[k] for k in ("vit", "connector", "vit_pos_embed")}
    rng = np.random.default_rng(6)
    n = 36
    patches = rng.uniform(-1, 1, (n, cfg.vit.patch_dim)).astype(np.float32)
    pos = np.concatenate([np.arange(18), np.arange(12) * 2, np.zeros(6, int)]).astype(np.int32)
    seg = np.asarray([1] * 18 + [2] * 12 + [0] * 6, np.int32)
    return cfg, tree, patches, pos, seg


@pytest.mark.parametrize("jax_impl", ["dense", "flash"])
def test_siglip_encode_matches_jax(tower, jax_impl):
    cfg, tree, patches, pos, seg = tower
    with jax.default_matmul_precision("float32"):
        want = jsiglip.siglip_encode(
            jax.tree.map(jnp.asarray, tree["vit"]), cfg.vit, jnp.asarray(patches),
            jnp.asarray(pos), jnp.asarray(seg), precision="float32", attn_impl=jax_impl)
    vit = params_from_numpy(tree["vit"], "cpu")
    args = (vit, cfg.vit, torch.tensor(patches), torch.tensor(pos), torch.tensor(seg))
    for impl in ("auto", "dense", "flash"):  # all the plain version on CPU tensors
        got = tsiglip.siglip_encode(*args, attn_impl=impl)
        assert got.shape == (36, cfg.vit.hidden_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_siglip_learned_positions_match_jax(tower):
    """rope=False: a learned position table instead of the 2-D RoPE."""
    cfg, _, patches, pos, seg = tower
    vcfg = dataclasses.replace(cfg.vit, rope=False)
    tree = randomized(jsiglip.init_siglip_params(jax.random.PRNGKey(1), vcfg, jnp.float32), 8)
    with jax.default_matmul_precision("float32"):
        want = jsiglip.siglip_encode(jax.tree.map(jnp.asarray, tree), vcfg,
                                     jnp.asarray(patches), jnp.asarray(pos), jnp.asarray(seg),
                                     precision="float32")
    got = tsiglip.siglip_encode(params_from_numpy(tree, "cpu"), vcfg, torch.tensor(patches),
                                torch.tensor(pos), torch.tensor(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_vit_tokens_matches_jax(tower):
    cfg, tree, patches, pos, seg = tower
    with jax.default_matmul_precision("float32"):
        want = jbagel.encode_vit_tokens(jax.tree.map(jnp.asarray, tree), cfg,
                                        jnp.asarray(patches), jnp.asarray(pos),
                                        jnp.asarray(seg), precision="float32")
    got = tbagel.encode_vit_tokens(params_from_numpy(tree, "cpu"), cfg, torch.tensor(patches),
                                   torch.tensor(pos), torch.tensor(seg))
    assert got.shape == (36, cfg.llm.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_from_numpy_carries_the_vit(tower):
    """The bridge carries the tower's stacked [L, in, out] weights and
    [L, d] LayerNorms unchanged: no SigLIP leaf is 4-D, so none is
    transposed."""
    cfg, tree, _, _, _ = tower
    got = params_from_numpy(tree, "cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(tree)
    tleaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(
        lambda t: t.numpy(), got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, j), (_, t) in zip(jleaves, tleaves):
        assert j.ndim < 4
        np.testing.assert_array_equal(t, j, err_msg=jax.tree_util.keystr(path))
    L, d = cfg.vit.num_hidden_layers, cfg.vit.hidden_size
    assert tuple(got["vit"]["layers"]["attn"]["q"]["w"].shape) == (L, d, d)
    assert tuple(got["vit"]["layers"]["ln1"]["w"].shape) == (L, d)


def test_init_siglip_params_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_bagel()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsiglip.init_siglip_params(torch.Generator(), cfg.vit)
    params = tsiglip.init_siglip_params(torch.Generator().manual_seed(0), cfg.vit,
                                        torch.float32, device="cpu")
    assert params["layers"]["ln1"]["w"].dtype == torch.float32
