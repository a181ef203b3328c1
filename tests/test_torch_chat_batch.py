"""Batched understanding: bagel_tpu_torch's chat_batch vs bagel_tpu's (CPU,
fp32 weights, tiny_bagel), over a full-precision cache and over an int8 one
(`kv_quant=True`).

Bars: the texts identical to JAX's for a batch whose rows carry no image,
one image, or a list of images of different sizes; over the full-precision
cache also identical to one session per row (`gen_text` on its own context).
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
from bagel_tpu_torch.inference.engine import BagelEngine
from bagel_tpu_torch.utils.bridge import params_from_numpy

from test_torch_qwen2 import randomized
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

MAX_LEN = 6


def _image(rng, h, w):
    return (rng.standard_normal((h, w, 3)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_bagel()
    tree = randomized(jbagel.init_bagel_params(jax.random.PRNGKey(0), cfg, jnp.float32), 9)
    tree["llm"]["lm_head"]["w"] = tree["llm"]["lm_head"]["w"] * 8.0  # no near ties
    jtok, ttok = JMockTokenizer(cfg.llm.vocab_size), MockTokenizer(cfg.llm.vocab_size)
    jparams, tparams = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    engines = {}
    for quant in (False, True):
        engines[quant] = (
            JEngine(jparams, cfg, jtok, jtok.new_token_ids, max_kv=512, kv_quant=quant),
            BagelEngine(tparams, cfg, ttok, ttok.new_token_ids, max_kv=512, device="cpu",
                        kv_quant=quant),
        )
    rng = np.random.default_rng(2)
    images = [[_image(rng, 28, 28), _image(rng, 28, 42)], _image(rng, 42, 28), None]
    prompts = ["compare the two images", "what is this?", "hello there"]
    return engines, images, prompts


@pytest.mark.parametrize("kv_quant", [False, True])
def test_chat_batch_matches_jax(setup, kv_quant):
    engines, images, prompts = setup
    jeng, teng = engines[kv_quant]
    assert teng.kv_dtype == (torch.int8 if kv_quant else torch.float32)
    with jax.default_matmul_precision("float32"):
        want = jeng.chat_batch(images, prompts, max_length=MAX_LEN)
    got = teng.chat_batch(images, prompts, max_length=MAX_LEN)
    assert got == want
    assert all(len(t.split()) > 0 for t in got)


def test_chat_batch_matches_single_sessions(setup):
    engines, images, prompts = setup
    _, teng = engines[False]
    got = teng.chat_batch(images, prompts, max_length=MAX_LEN)
    for imgs, prompt, text in zip(images, prompts, got):
        ctx = teng.init_context()
        for im in [] if imgs is None else ([imgs] if isinstance(imgs, np.ndarray) else imgs):
            ctx = teng.update_context_image(im, ctx, vae=False, vit=True)
        ctx = teng.update_context_text(prompt, ctx)
        assert text == teng.gen_text(ctx, max_length=MAX_LEN)


def test_chat_batch_text_only_rows(setup):
    engines, _, _ = setup
    jeng, teng = engines[True]
    prompts = ["a", "a much longer question about nothing in particular?"]
    with jax.default_matmul_precision("float32"):
        want = jeng.chat_batch([None, None], prompts, max_length=4)
    assert teng.chat_batch([None, None], prompts, max_length=4) == want
