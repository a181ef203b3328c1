"""The text-to-image slice end to end: bagel_tpu_torch's BagelEngine vs
bagel_tpu's on tiny_bagel (visual_und=False), the same bridged random params
(llm2vae != 0, gen expert != und expert, norms != 1) and the same numpy
init noise, CPU fp32. Bars: final latent max-abs 1e-4 (both sides fp32),
uint8 image within 1 level."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_bagel
from bagel_tpu.data.tokenizer import MockTokenizer as JMockTokenizer
from bagel_tpu.inference.engine import BagelEngine as JEngine
from bagel_tpu.models import bagel as jbagel
from bagel_tpu_torch.data.tokenizer import MockTokenizer
from bagel_tpu_torch.inference import engine as tengine
from bagel_tpu_torch.models import bagel as tbagel
from bagel_tpu_torch.utils.bridge import params_from_numpy

from asserts import assert_close_live
from test_torch_qwen2 import randomized
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

PROMPT = "a red cube on a blue table"
SHAPE = (32, 32)  # 8 x 8 latent tokens on tiny_bagel
# timestep_shift 3 with 8 timesteps: 6 CFG-on steps (3 branches), then 1
# CFG-off step (cond only), as in the on-card run
SCHEDULE = dict(num_timesteps=8, timestep_shift=3.0, cfg_text_scale=4.0,
                cfg_img_scale=1.5)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_bagel(visual_und=False)
    tree = randomized(
        jbagel.init_bagel_params(jax.random.PRNGKey(0), cfg, jnp.float32), 7)
    assert np.abs(tree["llm2vae"]["w"]).max() > 0
    assert not np.allclose(tree["llm"]["layers"]["attn"]["q"]["w"],
                           tree["llm"]["layers"]["attn_gen"]["q"]["w"])
    jtok = JMockTokenizer(cfg.llm.vocab_size)
    ttok = MockTokenizer(cfg.llm.vocab_size)
    assert ttok.new_token_ids == jtok.new_token_ids
    jeng = JEngine(jax.tree.map(jnp.asarray, tree), cfg, jtok, jtok.new_token_ids,
                   max_kv=256)
    teng = tengine.BagelEngine(params_from_numpy(tree, "cpu"), cfg, ttok,
                               ttok.new_token_ids, max_kv=256, device="cpu")
    n = (SHAPE[0] // cfg.latent_downsample) * (SHAPE[1] // cfg.latent_downsample)
    noise = np.random.default_rng(8).standard_normal(
        (n, cfg.patch_latent_dim)).astype(np.float32)
    return cfg, tree, jeng, teng, noise


def _contexts(eng):
    """The contexts interleave_inference builds for one text prompt."""
    ctx = eng.init_context()
    cfg_img = ctx.copy()
    cfg_text = ctx.copy()
    ctx = eng.update_context_text(PROMPT, ctx)
    cfg_img = eng.update_context_text(PROMPT, cfg_img)
    return dict(ctx=ctx, cfg_text_precontext=cfg_text, cfg_img_precontext=cfg_img)


@pytest.mark.parametrize("renorm", ["global", "channel", "text_channel"])
def test_gen_image_latent_matches_jax(setup, renorm):
    _, _, jeng, teng, noise = setup
    with jax.default_matmul_precision("float32"):
        want = jeng.gen_image(SHAPE, **_contexts(jeng), init_noise=noise,
                              return_latent=True, cfg_renorm_type=renorm, **SCHEDULE)
    got = teng.gen_image(SHAPE, **_contexts(teng), init_noise=noise,
                         return_latent=True, cfg_renorm_type=renorm, **SCHEDULE)
    assert got.shape == want.shape == noise.shape
    assert np.isfinite(got).all()
    # the flow must have moved the latent well off the noise
    assert_close_live(got, np.asarray(want), moved_from=noise, floor=0.1,
                      rtol=0, atol=1e-4, name="latent")


def test_call_image_matches_jax(setup, monkeypatch):
    """The user entry point, __call__: the JAX engine draws x_1 from
    PRNGKey(0); the port is handed the same draw."""
    cfg, _, jeng, teng, noise = setup
    jnoise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), noise.shape, jnp.float32))
    monkeypatch.setattr(tengine, "_initial_noise",
                        lambda job, shape, device: torch.tensor(jnoise))
    kw = dict(understanding_output=False, image_shapes=SHAPE, **SCHEDULE)
    with jax.default_matmul_precision("float32"):
        want = jeng(text=PROMPT, **kw)["image"]
    got = teng(text=PROMPT, **kw)["image"]
    assert got.shape == want.shape == SHAPE + (3,) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert got.std() > 0


def test_update_leaves_sibling_context_untouched(setup):
    """KV writes are out of place: updating ctx must leave a context copied
    from it (sharing its buffers) bit-identical, as immutable JAX arrays do."""
    _, _, _, teng, noise = setup
    ctx = teng.init_context()
    ctx = teng.update_context_text("first", ctx)
    sibling = ctx.copy()
    k0, v0, len0 = (sibling.cache.k.clone(), sibling.cache.v.clone(),
                    sibling.cache.length.clone())
    ctx = teng.update_context_text(PROMPT, ctx)
    assert not torch.equal(ctx.cache.k, k0)
    teng.gen_image(SHAPE, ctx, cfg_text_precontext=sibling, cfg_img_precontext=sibling,
                   init_noise=noise, return_latent=True, num_timesteps=3)
    assert torch.equal(sibling.cache.k, k0)
    assert torch.equal(sibling.cache.v, v0)
    assert torch.equal(sibling.cache.length, len0)


def test_later_slices_raise(setup):
    """The features of later slices run: speculative decode (here, and
    tests/test_torch_speculative.py), editing and TaylorSeer
    (tests/test_torch_edit.py, test_torch_taylorseer.py). Serving over a
    mesh, which raised here, is held in tests/test_torch_sharded_inference.py."""
    _, _, _, teng, _ = setup
    kw = dict(understanding_output=True, max_think_token_n=4)
    assert teng(text="x", speculative=4, **kw) == teng(text="x", **kw)


def test_schedule_runs_both_phases():
    ts, _ = tbagel.shifted_timesteps(SCHEDULE["num_timesteps"], SCHEDULE["timestep_shift"])
    assert ((ts > 0.4) & (ts <= 1.0)).sum() == 6 and (ts <= 0.4).sum() == 1


def test_shifted_timesteps_bit_exact():
    for n in (2, 3, 8, 50, 51):
        for shift in (1.0, 3.0, 1.7):
            jt, jd = jbagel.shifted_timesteps(n, shift)
            tt, td = tbagel.shifted_timesteps(n, shift)
            np.testing.assert_array_equal(tt, np.asarray(jt))
            np.testing.assert_array_equal(td, np.asarray(jd))


@pytest.mark.parametrize("renorm", ["global", "channel", "text_channel"])
@pytest.mark.parametrize("with_img", [True, False])
def test_cfg_combine_matches_jax(renorm, with_img):
    rng = np.random.default_rng(9)
    vc, vt, vi = (rng.standard_normal((12, 16)).astype(np.float32) for _ in range(3))
    vi = vi if with_img else None
    for text_s, img_s, rmin in ((4.0, 1.5, 0.0), (2.0, 3.0, 0.5), (1.0, 1.5, 0.0)):
        want = jbagel.cfg_combine(jnp.asarray(vc), jnp.asarray(vt),
                                  None if vi is None else jnp.asarray(vi),
                                  text_s, img_s, renorm, rmin)
        got = tbagel.cfg_combine(torch.tensor(vc), torch.tensor(vt),
                                 None if vi is None else torch.tensor(vi),
                                 text_s, img_s, renorm, rmin)
        assert_close_live(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                          name="combined velocity")


def test_patchify_roundtrip_matches_jax():
    z = np.random.default_rng(10).standard_normal((8, 6, 4)).astype(np.float32)
    got = tbagel.patchify_latent(torch.tensor(z), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbagel.patchify_latent(jnp.asarray(z), 2)))
    np.testing.assert_array_equal(tbagel.unpatchify_latent(got, 4, 3, 2, 4).numpy(), z)


def test_params_from_numpy_covers_every_leaf(setup):
    _, tree, _, teng, _ = setup
    jleaves = jax.tree_util.tree_leaves_with_path(tree)
    tleaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), teng.params,
                     is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, j), (_, t) in zip(jleaves, tleaves):
        want = j.transpose(3, 2, 0, 1) if j.ndim == 4 else j  # HWIO -> OIHW
        np.testing.assert_array_equal(t, want, err_msg=jax.tree_util.keystr(path))


def test_params_from_numpy_bf16_bits():
    x = jnp.asarray(np.random.default_rng(11).standard_normal((3, 5)), jnp.bfloat16)
    got = params_from_numpy({"w": np.asarray(x)}, "cpu")["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(x, np.float32))


def test_port_init_matches_jax_tree(setup):
    """init_bagel_params builds the JAX tree's paths and shapes (conv kernels
    OIHW), with llm2vae zero and the gen expert a copy of the und expert."""
    cfg, tree, _, _, _ = setup
    params = tbagel.init_bagel_params(torch.Generator().manual_seed(0), cfg,
                                      torch.float32, device="cpu")
    as_np = jax.tree.map(lambda t: t.numpy(), params,
                         is_leaf=lambda x: isinstance(x, torch.Tensor))
    jleaves = jax.tree_util.tree_leaves_with_path(tree)
    tleaves = jax.tree_util.tree_leaves_with_path(as_np)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, j), (_, t) in zip(jleaves, tleaves):
        assert t.shape == (j.transpose(3, 2, 0, 1) if j.ndim == 4 else j).shape
    assert np.abs(as_np["llm2vae"]["w"]).max() == 0
    layers = as_np["llm"]["layers"]
    np.testing.assert_array_equal(layers["attn"]["q"]["w"], layers["attn_gen"]["q"]["w"])
    # visual_und=True adds the SigLIP tower, the connector and vit_pos_embed
    full = dataclasses.replace(cfg, visual_und=True)
    jleaves = jax.tree_util.tree_leaves_with_path(
        jbagel.init_bagel_params(jax.random.PRNGKey(0), full, jnp.float32))
    tleaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(
        lambda t: t.numpy(),
        tbagel.init_bagel_params(torch.Generator().manual_seed(0), full, torch.float32,
                                 device="cpu"),
        is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (path, j), (_, t) in zip(jleaves, tleaves):
        assert t.shape == (j.transpose(3, 2, 0, 1) if j.ndim == 4 else j).shape, path
        if jax.tree_util.keystr(path).startswith("['vit_pos_embed']"):
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)  # a frozen table
