"""The understanding slice end to end: bagel_tpu_torch's BagelEngine vs
bagel_tpu's on tiny_bagel (visual_und=True), the same bridged random params
(every leaf perturbed) and the same seeded image, CPU fp32. Bars: the
decoded text identical; the contexts' kv_len, rope and text_ids equal; the
ViT block's K/V within 1e-4.
"""

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
from bagel_tpu_torch.utils.bridge import params_from_numpy

from test_torch_qwen2 import randomized

QUESTION = "What is in the picture?"
MAX_KV = 512  # the think system prompt is 229 mock tokens
DECODE = dict(max_think_token_n=10)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_bagel()
    tree = randomized(jbagel.init_bagel_params(jax.random.PRNGKey(0), cfg, jnp.float32), 21)
    jtok, ttok = JMockTokenizer(cfg.llm.vocab_size), MockTokenizer(cfg.llm.vocab_size)
    jeng = JEngine(jax.tree.map(jnp.asarray, tree), cfg, jtok, jtok.new_token_ids,
                   max_kv=MAX_KV)
    teng = tengine.BagelEngine(params_from_numpy(tree, "cpu"), cfg, ttok, ttok.new_token_ids,
                               max_kv=MAX_KV, device="cpu")
    # 60 x 62 px: cropped to 56 x 56, a 4 x 4 patch grid
    image = np.random.default_rng(22).uniform(-1, 1, (60, 62, 3)).astype(np.float32)
    return cfg, jeng, teng, image


def _vqa_context(eng, image):
    ctx = eng.init_context()
    ctx = eng.update_context_image(image, ctx, vae=False, vit=True)
    return eng.update_context_text(QUESTION, ctx)


def test_vqa_context_matches_jax(setup):
    _, jeng, teng, image = setup
    with jax.default_matmul_precision("float32"):
        jctx = _vqa_context(jeng, image)
    tctx = _vqa_context(teng, image)
    assert (tctx.kv_len, tctx.rope, tctx.text_ids) == (jctx.kv_len, jctx.rope, jctx.text_ids)
    assert tctx.kv_len == 16 + 2 + len(QUESTION) + 2 and tctx.rope == 1 + len(QUESTION) + 2
    live = tctx.kv_len
    np.testing.assert_array_equal(tctx.cache.length.numpy(), np.asarray(jctx.cache.length))
    for got, want in ((tctx.cache.k, jctx.cache.k), (tctx.cache.v, jctx.cache.v)):
        np.testing.assert_allclose(got[:, :, :live].numpy(), np.asarray(want)[:, :, :live],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("think", [False, True])
def test_call_understanding_matches_jax(setup, think):
    _, jeng, teng, image = setup
    kw = dict(understanding_output=True, think=think, **DECODE)
    with jax.default_matmul_precision("float32"):
        want = jeng(image=image, text=QUESTION, **kw)
    got = teng(image=image, text=QUESTION, **kw)
    assert got["image"] is None and want["image"] is None
    assert got["text"] == want["text"]
    assert len(got["text"].split()) == DECODE["max_think_token_n"]  # no eos on random weights


def test_think_generation_matches_jax(setup, monkeypatch):
    """think=True on the generation path: the planning text decoded first
    (and fed back into the context), then the image."""
    cfg, jeng, teng, _ = setup
    shape = (32, 32)
    n = (shape[0] // cfg.latent_downsample) ** 2
    jnoise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n, cfg.patch_latent_dim),
                                          jnp.float32))
    monkeypatch.setattr(tengine, "_initial_noise",
                        lambda job, shape, device: torch.tensor(jnoise))
    kw = dict(think=True, max_think_token_n=6, image_shapes=shape, num_timesteps=3,
              cfg_text_scale=4.0)
    with jax.default_matmul_precision("float32"):
        want = jeng(text="a red cube", **kw)
    got = teng(text="a red cube", **kw)
    assert got["text"] == want["text"] and len(got["text"].split()) == 6
    assert got["image"].shape == want["image"].shape == shape + (3,)
    assert np.abs(got["image"].astype(int) - want["image"].astype(int)).max() <= 1


def test_gen_text_leaves_the_context_untouched(setup):
    _, _, teng, image = setup
    ctx = _vqa_context(teng, image)
    k0, v0, len0 = ctx.cache.k.clone(), ctx.cache.v.clone(), ctx.cache.length.clone()
    first = teng.gen_text(ctx, max_length=8)
    assert torch.equal(ctx.cache.k, k0) and torch.equal(ctx.cache.v, v0)
    assert torch.equal(ctx.cache.length, len0)
    assert teng.gen_text(ctx, max_length=8) == first


def test_sampled_answer_is_reproducible(setup):
    _, _, teng, image = setup
    ctx = _vqa_context(teng, image)

    def answer(seed):
        return teng.gen_text(ctx, max_length=8, do_sample=True, temperature=1.0,
                             rng=torch.Generator().manual_seed(seed))

    assert answer(1) == answer(1)
    assert answer(1) != answer(2)


@pytest.mark.parametrize("think", [False, True])
def test_understanding_prefills_one_context(setup, monkeypatch, think):
    """The CFG contexts are never read on the understanding path: one text
    prefill per text input (and one for the think system prompt)."""
    _, _, teng, image = setup
    calls = []
    real = tengine._prefill_text
    monkeypatch.setattr(tengine, "_prefill_text", lambda *a: calls.append(1) or real(*a))
    teng(image=image, text=QUESTION, understanding_output=True, think=think,
         max_think_token_n=2)
    assert len(calls) == 1 + think
