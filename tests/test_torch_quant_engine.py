"""Quantized serving on the port vs bagel_tpu (CPU).

- `llm_extend` over each quantization mode, fused and not, f32 activations:
  weight-only modes within 1e-4; w8a8 within 1e-3 (the activations are
  quantized per token on each side, and a code that lands on a half in one
  framework's f32 rounding may flip in the other: one step moves one
  product by xs * ws, ~1e-3 of a value).
- The engines: a quantized embedding makes both run bf16 (the JAX rule), so
  the tiny w8a8 text-to-image latent and the tiny int4 VQA's teacher-forced
  logits are held under bf16 bounds (below), not token identity.
- Which attentions take the int8 kernel under BAGEL_FLASH_INT8: every block
  of more than one token, never a decode step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_bagel, tiny_qwen2
from bagel_tpu.data.tokenizer import MockTokenizer as JMockTokenizer
from bagel_tpu.inference.engine import BagelEngine as JEngine
from bagel_tpu.models import bagel as jbagel
from bagel_tpu.models import qwen2 as jq
from bagel_tpu.utils import quant as jquant
from bagel_tpu_torch.data.tokenizer import MockTokenizer
from bagel_tpu_torch.inference import engine as tengine
from bagel_tpu_torch.models import qwen2 as tq
from bagel_tpu_torch.ops import flash as tflash
from bagel_tpu_torch.utils import quant as tquant
from bagel_tpu_torch.utils.bridge import params_from_numpy

from asserts import assert_close_live
from test_torch_qwen2 import randomized
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

MODES = ["int8", "w8a8", "int4", "nf4"]
# bf16 engines: the two frameworks round bf16 activations at different
# points (fused vs separate ops, bias before or after the rounding); over a
# few layers that is a few bf16 ulp (2^-8 relative) of a value. Measured on
# these seeds: 5.8e-3 and 5.6e-3.
LATENT_TOL = 2e-2  # max-abs on a unit-variance latent after 8 steps
LOGITS_REL = 2e-2  # ||got - want|| / ||want|| of the teacher-forced logits


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_llm_extend_quantized_matches_jax(mode, fused):
    cfg = tiny_qwen2(layer_module="mot")
    tree = randomized(jq.init_qwen2_params(jax.random.PRNGKey(0), cfg, jnp.float32), 1)
    jp = jquant.quantize_llm_params(jax.tree.map(jnp.asarray, tree), mode)
    tp = tquant.quantize_llm_params(params_from_numpy(tree, "cpu"), mode)
    if fused:
        jp, tp = jq.fuse_llm_params(jp), tq.fuse_llm_params(tp)
    tol = dict(rtol=1e-3, atol=1e-3) if mode == "w8a8" else dict(rtol=1e-4, atol=1e-4)
    rng = np.random.default_rng(2)
    b, s, d = 2, 64, cfg.hidden_size
    jc = jq.kv_cache_init(cfg, b, s, jnp.float32)
    tc = tq.kv_cache_init(cfg, b, s, torch.float32, device="cpu")
    # a causal prefill (ragged rows), then a non-causal gen block over it
    for t, und_len, causal, pos0 in ((16, 16, True, None), (10, 2, False, [13, 9])):
        valid = np.asarray([13, 9], np.int32) if causal else np.full((b,), t, np.int32)
        if causal:
            pos = np.zeros((b, t), np.int32)
            for r in range(b):
                pos[r, : valid[r]] = np.arange(valid[r])
        else:
            pos = np.broadcast_to(np.asarray(pos0, np.int32)[:, None], (b, t)).copy()
        x = rng.standard_normal((b, t, d)).astype(np.float32)
        with jax.default_matmul_precision("float32"):
            jh, jc = jq.llm_extend(jp, cfg, jnp.asarray(x), jnp.asarray(pos), jc,
                                   jnp.asarray(valid), und_len=und_len, causal=causal,
                                   update_cache=True, precision="float32")
        th, tc = tq.llm_extend(tp, cfg, torch.tensor(x), torch.tensor(pos), tc,
                               torch.tensor(valid), und_len=und_len, causal=causal,
                               update_cache=True)
        rows = np.arange(t)[None, :] < valid[:, None]
        np.testing.assert_allclose(th.numpy()[rows], np.asarray(jh)[rows], **tol)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **tol)


def _bf16_rest(tree):
    """The non-LLM leaves in bf16, as the card runs them (numpy bf16 arrays
    bridge bit for bit)."""
    out = dict(tree)
    for key, val in tree.items():
        if key != "llm":
            out[key] = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), val)
    return out


def _engines(cfg, seed, mode, max_kv, bf16_rest=True):
    tree = randomized(jbagel.init_bagel_params(jax.random.PRNGKey(0), cfg, jnp.float32), seed)
    if bf16_rest:
        tree = _bf16_rest(tree)
    jp = jquant.quantize_bagel_params(jax.tree.map(jnp.asarray, tree), mode)
    tp = tquant.quantize_bagel_params(params_from_numpy(tree, "cpu"), mode)
    jp["llm"], tp["llm"] = jq.fuse_llm_params(jp["llm"]), tq.fuse_llm_params(tp["llm"])
    jtok, ttok = JMockTokenizer(cfg.llm.vocab_size), MockTokenizer(cfg.llm.vocab_size)
    jeng = JEngine(jp, cfg, jtok, jtok.new_token_ids, max_kv=max_kv)
    teng = tengine.BagelEngine(tp, cfg, ttok, ttok.new_token_ids, max_kv=max_kv,
                               device="cpu")
    assert jeng.cache_dtype == jnp.bfloat16 and teng.cache_dtype == torch.bfloat16
    return jeng, teng


def test_w8a8_text_to_image_matches_jax():
    cfg = tiny_bagel(visual_und=False)
    jeng, teng = _engines(cfg, 7, "w8a8", 256)
    shape = (32, 32)
    n = (shape[0] // cfg.latent_downsample) ** 2
    noise = np.random.default_rng(8).standard_normal((n, cfg.patch_latent_dim)).astype(np.float32)
    kw = dict(num_timesteps=8, timestep_shift=3.0, cfg_text_scale=4.0, cfg_img_scale=1.5,
              init_noise=noise, return_latent=True)

    def contexts(eng):
        ctx = eng.init_context()
        cfg_text, cfg_img = ctx.copy(), ctx.copy()
        ctx = eng.update_context_text("a red cube", ctx)
        cfg_img = eng.update_context_text("a red cube", cfg_img)
        return dict(ctx=ctx, cfg_text_precontext=cfg_text, cfg_img_precontext=cfg_img)

    with jax.default_matmul_precision("float32"):
        want = np.asarray(jeng.gen_image(shape, **contexts(jeng), **kw), np.float32)
    got = teng.gen_image(shape, **contexts(teng), **kw)
    assert np.isfinite(got).all()
    assert_close_live(got, want, moved_from=noise, floor=0.1, rtol=0, atol=LATENT_TOL,
                      name="latent")


@pytest.mark.parametrize("bf16_rest", [True, False])
def test_int4_vqa_teacher_forced_logits_match_jax(bf16_rest):
    """bf16_rest=False: an f32 SigLIP tower beside the bf16 LLM, whose
    products JAX promotes to f32 (the port casts the patches to match)."""
    cfg = tiny_bagel()
    jeng, teng = _engines(cfg, 21, "int4", 512, bf16_rest)
    image = np.random.default_rng(22).uniform(-1, 1, (56, 56, 3)).astype(np.float32)
    question = "What is in the picture?"

    def context(eng):
        ctx = eng.update_context_image(image, eng.init_context(), vae=False, vit=True)
        return eng.update_context_text(question, ctx)

    with jax.default_matmul_precision("float32"):
        jctx = context(jeng)
        answer = jeng.gen_text(jctx, max_length=8)
    ids = [int(i) for i in answer.split()]
    assert ids, "the JAX engine answered nothing: change the weight seed"
    tctx = context(teng)
    block = [jeng.new_token_ids["bos_token_id"]] + ids[:-1]
    t = len(block)
    pos = np.arange(jctx.rope, jctx.rope + t, dtype=np.int32)[None]
    with jax.default_matmul_precision("float32"):
        jh, _ = jq.llm_extend(jeng.params["llm"], cfg.llm,
                              jq.embed_tokens(jeng.params["llm"], jnp.asarray([block])),
                              jnp.asarray(pos), jctx.cache, jnp.asarray([t]), und_len=t,
                              causal=True, update_cache=False)
        want = np.asarray(jq.lm_logits(jeng.params["llm"], jh[0]), np.float32)
    th, _ = tq.llm_extend(teng.params["llm"], cfg.llm,
                          tq.embed_tokens(teng.params["llm"], torch.tensor([block])),
                          torch.tensor(pos), tctx.cache, torch.tensor([t], dtype=torch.int32),
                          und_len=t, causal=True, update_cache=False)
    got = tq.lm_logits(teng.params["llm"], th[0]).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert got.shape == want.shape == (t, cfg.llm.vocab_size)
    assert rel <= LOGITS_REL
    # the port's own answer through __call__ runs end to end
    out = teng(image=image, text=question, understanding_output=True, max_think_token_n=8)
    assert out["image"] is None and isinstance(out["text"], str)


def test_int8_attention_takes_every_block_but_decode(monkeypatch):
    """Under BAGEL_FLASH_INT8 the blocks that JAX sends to its kernel on a
    TPU (prefill, gen block) take the int8 attention; decode steps do not."""
    cfg = tiny_qwen2()
    tree = randomized(jq.init_qwen2_params(jax.random.PRNGKey(0), cfg, jnp.float32), 4)
    tp = tquant.quantize_llm_params(params_from_numpy(tree, "cpu"), "w8a8")
    seen = []
    real = tflash.flash_cached_attention_plain

    def spy(q, *a, int8_compute=False, **kw):
        seen.append((q.shape[1], int8_compute))
        return real(q, *a, int8_compute=int8_compute, **kw)

    monkeypatch.setattr(tq, "flash_cached_attention_plain", spy)
    monkeypatch.setenv("BAGEL_FLASH_INT8", "1")
    cache = tq.kv_cache_init(cfg, 1, 64, torch.float32, device="cpu")
    x = torch.randn(1, 12, cfg.hidden_size, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(12, dtype=torch.int32)[None]
    _, cache = tq.llm_extend(tp, cfg, x, pos, cache, torch.tensor([12]), und_len=12,
                             causal=True, update_cache=True)
    tq.decode_text(tp, cfg, cache, torch.tensor([1]), torch.tensor([12]), max_steps=3,
                   eos_id=-1)
    L = cfg.num_hidden_layers
    assert seen == [(12, True)] * L + [(1, False)] * (3 * L)
