"""Editing (an image into a generation context): bagel_tpu_torch against
bagel_tpu on tiny_bagel, the same bridged random params (every leaf
perturbed, llm2vae included), CPU fp32.

Bars: vae_encode within 1e-4 relative to the output scale; the VAE block's
K/V within 1e-4; an edit's latent (VAE block, ViT block, text, then the
denoise) at max-abs 1e-4; `__call__(image=..., text=...)` within one
uint8 level; ImageTransform identical. The port draws the posterior sample
and x_1 from torch generators where JAX uses PRNGKey(0): the tests hand
the port JAX's draws."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_bagel, tiny_vae
from bagel_tpu.data import transforms as jtransforms
from bagel_tpu.data.tokenizer import MockTokenizer as JMockTokenizer
from bagel_tpu.inference import engine as jengine
from bagel_tpu.models import bagel as jbagel
from bagel_tpu.models import vae as jvae
from bagel_tpu_torch.data import transforms as ttransforms
from bagel_tpu_torch.data.tokenizer import MockTokenizer
from bagel_tpu_torch.inference import engine as tengine
from bagel_tpu_torch.models import vae as tvae
from bagel_tpu_torch.utils.bridge import params_from_numpy

from asserts import assert_close_live
from test_torch_qwen2 import randomized
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

EDIT = "make the sky green"
CFG = dict(num_timesteps=6, timestep_shift=3.0, cfg_text_scale=4.0, cfg_img_scale=1.5)
MAX_KV = 512


def jax_normal(shape):
    """The standard normal draw of jax.random.normal(PRNGKey(0), shape)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), tuple(shape), jnp.float32))


@pytest.fixture
def jax_posterior(monkeypatch):
    """The port's posterior sample takes JAX's PRNGKey(0) draw."""
    monkeypatch.setattr(tvae, "_posterior_noise",
                        lambda shape, generator, device: torch.tensor(jax_normal(shape)))


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_bagel()
    tree = randomized(jbagel.init_bagel_params(jax.random.PRNGKey(0), cfg, jnp.float32), 41)
    assert np.abs(tree["llm2vae"]["w"]).max() > 0
    jtok, ttok = JMockTokenizer(cfg.llm.vocab_size), MockTokenizer(cfg.llm.vocab_size)
    jeng = jengine.BagelEngine(jax.tree.map(jnp.asarray, tree), cfg, jtok, jtok.new_token_ids,
                               max_kv=MAX_KV, vae_transform=jtransforms.ImageTransform(64, 16, 16))
    teng = tengine.BagelEngine(params_from_numpy(tree, "cpu"), cfg, ttok, ttok.new_token_ids,
                               max_kv=MAX_KV, vae_transform=ttransforms.ImageTransform(64, 16, 16),
                               device="cpu")
    # 32 x 32 px: an 8 x 8 latent grid (64 tokens) and a 2 x 2 patch grid
    image = np.random.default_rng(42).uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    n = (32 // cfg.latent_downsample) ** 2
    noise = np.random.default_rng(43).standard_normal((n, cfg.patch_latent_dim)).astype(np.float32)
    return cfg, tree, jeng, teng, image, noise


@pytest.mark.parametrize("sample", [False, True])
def test_vae_encode_matches_jax(sample, jax_posterior):
    cfg = tiny_vae()
    tree = randomized(jvae.init_vae_params(jax.random.PRNGKey(0), cfg, jnp.float32), 44)
    images = np.random.default_rng(45).uniform(-1, 1, (2, 16, 12, 3)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jvae.vae_encode(jax.tree.map(jnp.asarray, tree), cfg,
                                          jnp.asarray(images), sample=sample,
                                          precision="float32"))
    got = tvae.vae_encode(params_from_numpy(tree, "cpu"), cfg, torch.tensor(images),
                          sample=sample).numpy()
    assert got.shape == want.shape == (2, 8, 6, cfg.z_channels)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-4, err


def test_vae_encode_sample_draws_from_generator():
    cfg = tiny_vae()
    params = tvae.init_vae_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    images = torch.rand((1, 8, 8, 3)) * 2 - 1

    def enc(seed):
        return tvae.vae_encode(params, cfg, images, torch.Generator().manual_seed(seed))

    mean = tvae.vae_encode(params, cfg, images, sample=False)
    assert torch.equal(enc(3), enc(3)) and not torch.equal(enc(3), enc(4))
    assert torch.equal(tvae.vae_encode(params, cfg, images), enc(0))  # the default: seed 0
    assert not torch.equal(enc(0), mean)


def test_prefill_vae_matches_jax(setup):
    """The VAE block [start, end, latents...] after a text block: its K/V
    at the context's offset, the lengths, and nothing else written."""
    cfg, _, jeng, teng, _, _ = setup
    n = 12
    rng = np.random.default_rng(46)
    lat = rng.standard_normal((n, cfg.patch_latent_dim)).astype(np.float32)
    lat_pos = rng.integers(0, cfg.max_latent_size ** 2, n).astype(np.int32)
    with jax.default_matmul_precision("float32"):
        jctx = jeng.update_context_text(EDIT, jeng.init_context())
        _, jcache = jengine._prefill_vae(
            jeng.params, cfg, jctx.cache, jeng._boundary_ids(), jnp.asarray(lat),
            jnp.asarray(lat_pos), jnp.asarray(jctx.rope, jnp.int32),
            jnp.asarray([n + 2], jnp.int32), jnp.asarray(0.0))
    tctx = teng.update_context_text(EDIT, teng.init_context())
    _, tcache = tengine._prefill_vae(
        teng.params, cfg, tctx.cache, teng._boundary_ids(), torch.tensor(lat),
        torch.tensor(lat_pos, dtype=torch.long), tctx.rope, torch.tensor([n + 2]))
    live = tctx.kv_len + n + 2
    assert tcache.length.tolist() == np.asarray(jcache.length).tolist() == [live]
    for got, want in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        new = slice(tctx.kv_len, live)
        assert_close_live(got[:, :, new].numpy(), np.asarray(want)[:, :, new], rtol=1e-4,
                          atol=1e-4, name="VAE block K/V")
        assert not got[:, :, live:].any()


def _edit_contexts(eng, image, **kw):
    """The contexts interleave_inference builds for (image, text) on the
    generation path."""
    ctx = eng.update_context_image(image, eng.init_context(), vae=True, vit=True, **kw)
    cfg_text = ctx.copy()
    ctx = eng.update_context_text(EDIT, ctx)
    cfg_img = eng.update_context_text(EDIT, eng.init_context())
    return dict(ctx=ctx, cfg_text_precontext=cfg_text, cfg_img_precontext=cfg_img)


def test_edit_latent_matches_jax(setup, jax_posterior):
    cfg, _, jeng, teng, image, noise = setup
    with jax.default_matmul_precision("float32"):
        jctx = _edit_contexts(jeng, image)
        want = np.asarray(jeng.gen_image(image.shape[:2], **jctx, init_noise=noise,
                                         return_latent=True, **CFG))
    tctx = _edit_contexts(teng, image)
    for key in jctx:
        j, t = jctx[key], tctx[key]
        assert (t.kv_len, t.rope, t.text_ids) == (j.kv_len, j.rope, j.text_ids), key
    n_lat, n_vit = 64, 4  # 32 px: 8 x 8 latents; 28 px for the ViT: 2 x 2 patches
    assert tctx["cfg_text_precontext"].kv_len == n_lat + 2 + n_vit + 2
    assert tctx["ctx"].rope == 2 + len(EDIT) + 2
    live = tctx["ctx"].kv_len
    for got, want_kv in ((tctx["ctx"].cache.k, jctx["ctx"].cache.k),
                         (tctx["ctx"].cache.v, jctx["ctx"].cache.v)):
        assert_close_live(got[:, :, :live].numpy(), np.asarray(want_kv)[:, :, :live],
                          rtol=1e-4, atol=1e-4, name="edit context K/V")
    got = teng.gen_image(image.shape[:2], **tctx, init_noise=noise, return_latent=True, **CFG)
    assert got.shape == want.shape == noise.shape and np.isfinite(got).all()
    assert_close_live(got, want, moved_from=noise, floor=0.1, rtol=0, atol=1e-4,
                      name="edit latent")


def test_edit_depends_on_the_image(setup):
    """The latent of an edit moves with the input image (the VAE and ViT
    blocks are read by the denoise), by ten times the parity bar at least,
    so that the latent's 1e-4 bar sees a wrong image pathway."""
    _, _, _, teng, image, noise = setup
    a = teng.gen_image(image.shape[:2], **_edit_contexts(teng, image), init_noise=noise,
                       return_latent=True, **CFG)
    b = teng.gen_image(image.shape[:2], **_edit_contexts(teng, -image), init_noise=noise,
                       return_latent=True, **CFG)
    assert np.abs(a - b).max() > 1e-3


def test_call_edit_matches_jax(setup, jax_posterior, monkeypatch):
    """The user entry point with vae_transform: a 34 x 35 array crops to
    32 x 32 and the output has that size. Both draws are JAX's."""
    cfg, _, jeng, teng, image, noise = setup
    monkeypatch.setattr(tengine, "_initial_noise",
                        lambda job, shape, device: torch.tensor(jax_normal(shape)))
    big = np.random.default_rng(47).uniform(-1, 1, (34, 35, 3)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = jeng(image=big, text=EDIT, understanding_output=False, **CFG)["image"]
    got = teng(image=big, text=EDIT, understanding_output=False, **CFG)["image"]
    assert got.shape == want.shape == (32, 32, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert got.std() > 0


def test_image_transform_matches_jax():
    from PIL import Image

    rng = np.random.default_rng(48)
    arr = rng.uniform(-1, 1, (37, 50, 3))  # float64: the transform casts
    for args in ((64, 16, 16), (1024, 512, 16), (980, 224, 14)):
        jt, tt = jtransforms.ImageTransform(*args), ttransforms.ImageTransform(*args)
        got, want = tt(arr), jt(arr)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        pil = Image.fromarray(rng.integers(0, 256, (300, 451, 3), dtype=np.uint8))
        got, want = tt(pil), jt(pil)
        assert got.shape == want.shape and got.shape[0] % args[2] == 0
        np.testing.assert_array_equal(got, want)
    for w, h in ((4000, 300), (100, 100), (1920, 1080), (7, 3000)):
        for num in (1, 3):
            resize = (64, 16, 16, 4096)
            assert (ttransforms.MaxLongEdgeMinShortEdgeResize(*resize).target_size(w, h, num)
                    == jtransforms.MaxLongEdgeMinShortEdgeResize(*resize).target_size(w, h, num))


def test_vit_grid_past_the_tables_raises(setup):
    """tiny_bagel's tower has an 8 x 8 position table and
    vit_max_num_patch_per_side = 16: a 4 x 4 grid (56 px) fits, a 5 x 5 one
    does not, and the error names the limit."""
    _, _, _, teng, _, _ = setup
    ctx = teng.update_context_image(np.zeros((56, 56, 3), np.float32), teng.init_context(),
                                    vae=False)
    assert ctx.kv_len == 16 + 2
    with pytest.raises(ValueError, match=r"5 x 5 grid.*vit_max_num_patch_per_side = 16.*56 px"):
        teng.update_context_image(np.zeros((70, 70, 3), np.float32), teng.init_context(),
                                  vae=False)
