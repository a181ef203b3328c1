"""Batched text-to-image and the CFG branch set: bagel_tpu_torch on
tiny_bagel (random params, llm2vae included), CPU fp32.

- gen_image_batch: J jobs in one denoise equal each job alone (1e-5), with
  and without TaylorSeer, across the CFG phase boundary where branches are
  dropped and the factors are laid out again per job.
- generate_batch equals per-request __call__ with the same generators
  (uint8 within 1); gen_batch_key equals bagel_tpu's.
- The CFG branches are assembled by role: where the port and bagel_tpu
  run the same combination, the latents agree with JAX's (max-abs 1e-4);
  a branch whose velocity is never read is not run; and where bagel_tpu
  combines the cfg_img velocity as the cfg_text one (a cfg_img context
  without a cfg_text context), the port gives the cond velocity."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_bagel
from bagel_tpu.data.tokenizer import MockTokenizer as JMockTokenizer
from bagel_tpu.inference import engine as jengine
from bagel_tpu.models import bagel as jbagel
from bagel_tpu_torch.data.tokenizer import MockTokenizer
from bagel_tpu_torch.inference import engine as tengine
from bagel_tpu_torch.utils.bridge import params_from_numpy

from asserts import assert_close_live, assert_signal_moved
from test_torch_qwen2 import randomized

SHAPE = (16, 16)  # 4 x 4 latent tokens on tiny_bagel
PROMPTS = ["a red bicycle", "two cats"]
KNOBS = dict(cfg_text_scale=2.0, cfg_img_scale=1.5, cfg_interval=(0.3, 1.0), num_timesteps=8,
             timestep_shift=2.0, cfg_renorm_type="global", cfg_renorm_min=0.0)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_bagel(visual_und=False)
    tree = randomized(jbagel.init_bagel_params(jax.random.PRNGKey(0), cfg, jnp.float32), 51)
    assert np.abs(tree["llm2vae"]["w"]).max() > 0
    jtok, ttok = JMockTokenizer(cfg.llm.vocab_size), MockTokenizer(cfg.llm.vocab_size)
    jeng = jengine.BagelEngine(jax.tree.map(jnp.asarray, tree), cfg, jtok, jtok.new_token_ids,
                               max_kv=256)
    teng = tengine.BagelEngine(params_from_numpy(tree, "cpu"), cfg, ttok, ttok.new_token_ids,
                               max_kv=256, device="cpu")
    n = (SHAPE[0] // cfg.latent_downsample) * (SHAPE[1] // cfg.latent_downsample)
    rng = np.random.default_rng(52)
    noises = [rng.standard_normal((n, cfg.patch_latent_dim)).astype(np.float32)
              for _ in PROMPTS]
    return cfg, jeng, teng, noises


def _job(eng, prompt, noise):
    """generate_batch's contexts: ctx, an empty cfg_text, cfg_img = ctx."""
    empty = eng.init_context()
    ctx = eng.update_context_text(prompt, empty)
    return dict(ctx=ctx, cfg_text_precontext=empty, cfg_img_precontext=ctx.copy(),
                init_noise=noise)


@pytest.mark.parametrize("taylorseer", [False, True])
def test_gen_image_batch_matches_singles(setup, taylorseer):
    """Three jobs (jobs 0 and 2 the same prompt and noise) in one denoise
    against each alone."""
    _, _, teng, noises = setup
    prompts, noises = PROMPTS + PROMPTS[:1], noises + noises[:1]
    knobs = dict(KNOBS, enable_taylorseer=taylorseer, taylorseer_threshold=2,
                 taylorseer_first_enhance=2)
    jobs = [_job(teng, p, nz) for p, nz in zip(prompts, noises)]
    singles = [teng.gen_image_batch(SHAPE, [job], return_latent=True, **knobs)[0]
               for job in jobs]
    batched = teng.gen_image_batch(SHAPE, jobs, return_latent=True, **knobs)
    assert len(batched) == 3
    for j, (got, want) in enumerate(zip(batched, singles)):
        assert_close_live(got, want, moved_from=noises[j], rtol=1e-5, atol=1e-5,
                          name=f"job {j} latent")
    assert_signal_moved(singles[0], singles[1], name="two prompts' latents")
    np.testing.assert_array_equal(batched[0], batched[2])


def test_generate_batch_matches_calls(setup):
    _, _, teng, _ = setup
    kw = dict(image_shapes=SHAPE, num_timesteps=6, cfg_text_scale=3.0)

    def reqs():
        return [dict(text=p, rng=torch.Generator().manual_seed(60 + i), **kw)
                for i, p in enumerate(PROMPTS)]

    out = teng.generate_batch(reqs())
    alone = [teng(**r)["image"] for r in reqs()]
    assert [o["text"] for o in out] == [None, None]
    for got, want in zip((o["image"] for o in out), alone):
        assert got.shape == SHAPE + (3,) and got.dtype == np.uint8 and got.std() > 0
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.abs(alone[0].astype(int) - alone[1].astype(int)).max() > 1


def test_generate_batch_refuses_mixed_keys(setup):
    _, _, teng, _ = setup
    with pytest.raises(ValueError, match="one shared batchable key"):
        teng.generate_batch([dict(text="a", image_shapes=SHAPE),
                             dict(text="b", image_shapes=SHAPE, enable_taylorseer=True)])


KEY_TABLE = [
    dict(text="x"),
    dict(text="x", cfg_text_scale=3.0, num_timesteps=50),  # the defaults, spelled out
    dict(text="x", enable_taylorseer=True),
    dict(text="x", enable_taylorseer=True, taylorseer_threshold=5),
    dict(text="x", enable_taylorseer=True, taylorseer_threshold=3),
    dict(text="x", enable_taylorseer=True, taylorseer_first_enhance=2),
    dict(text="x", cfg_interval=[0.4, 1.0]),  # a list's repr is not a tuple's
    dict(text="x", image_shapes=(512, 512), speculative=0, think=False),
    dict(text="x", rng="a generator"),
    dict(text="x", think=True),
    dict(text="x", understanding_output=True),
    dict(text=""),
    dict(image=np.zeros((4, 4, 3)), text="x"),
    dict(text="x", max_think_token_n=3),
]


@pytest.mark.parametrize("i", range(len(KEY_TABLE)))
def test_gen_batch_key_matches_jax(i):
    kw = KEY_TABLE[i]
    assert tengine.gen_batch_key(kw) == jengine.gen_batch_key(kw)


def test_taylorseer_knobs_split_gen_batch_key():
    keys = [tengine.gen_batch_key(kw) for kw in KEY_TABLE[:6]]
    assert keys[0] == keys[1] and None not in keys
    assert keys[2] == keys[4] and len({keys[0], keys[2], keys[3], keys[5]}) == 4


# (has cfg_text context, has cfg_img context, cfg_text_scale, cfg_img_scale)
# -> the branches the port runs in the CFG window; in each of these cases
# bagel_tpu's combination is the same
AGREE = {
    "all three": ((True, True, 4.0, 1.5), 3),
    "text scale 1": ((True, True, 1.0, 1.5), 1),  # JAX runs [cond, cfg_img] and reads cond
    "image scale 1": ((True, True, 4.0, 1.0), 2),
    "no cfg_img context": ((True, False, 4.0, 1.5), 2),
    "cfg_img only, text scale 1": ((False, True, 1.0, 1.5), 1),  # JAX: [cond, cfg_img]
}


def _contexts(eng, has_text, has_img):
    """cond, an empty cfg_text and a cfg_img that differs from both (in an
    edit it lacks the image; here it holds another text), so that each
    branch's velocity is its own."""
    ctx = eng.init_context()
    cfg_text, cfg_img = ctx.copy(), ctx.copy()
    ctx = eng.update_context_text(PROMPTS[0], ctx)
    cfg_img = eng.update_context_text(PROMPTS[1], cfg_img)
    return dict(ctx=ctx, cfg_text_precontext=cfg_text if has_text else None,
                cfg_img_precontext=cfg_img if has_img else None)


def _branch_counts(monkeypatch):
    seen = []
    real = tengine._denoise_phase
    monkeypatch.setattr(tengine, "_denoise_phase",
                        lambda *a, **k: seen.append(k["n_branches"]) or real(*a, **k))
    return seen


@pytest.mark.parametrize("case", list(AGREE))
def test_cfg_branches_by_role_match_jax(setup, case, monkeypatch):
    _, jeng, teng, noises = setup
    (has_text, has_img, text_s, img_s), nb = AGREE[case]
    kw = dict(KNOBS, cfg_text_scale=text_s, cfg_img_scale=img_s, init_noise=noises[0],
              return_latent=True)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jeng.gen_image(SHAPE, **_contexts(jeng, has_text, has_img), **kw))
    seen = _branch_counts(monkeypatch)
    got = teng.gen_image(SHAPE, **_contexts(teng, has_text, has_img), **kw)
    assert seen == [nb, 1]  # the CFG window, then cond alone
    assert_close_live(got, want, moved_from=noises[0], floor=0.1, rtol=0, atol=1e-4,
                      name="latent")


def test_cfg_img_without_cfg_text_gives_cond(setup, monkeypatch):
    """A cfg_img context without a cfg_text one, cfg_text_scale > 1: the
    port runs the cond branch alone, as with no precontext at all; the JAX
    engine runs [cond, cfg_img] and feeds the image velocity to cfg_combine
    as v_text, which moves its latent off its own cond-only one."""
    _, jeng, teng, noises = setup
    kw = dict(KNOBS, init_noise=noises[0], return_latent=True)
    with jax.default_matmul_precision("float32"):
        j_fault = np.asarray(jeng.gen_image(SHAPE, **_contexts(jeng, False, True), **kw))
        j_cond = np.asarray(jeng.gen_image(SHAPE, **_contexts(jeng, False, False), **kw))
    seen = _branch_counts(monkeypatch)
    got = teng.gen_image(SHAPE, **_contexts(teng, False, True), **kw)
    cond = teng.gen_image(SHAPE, **_contexts(teng, False, False), **kw)
    assert seen == [1, 1, 1, 1]
    np.testing.assert_array_equal(got, cond)
    assert_close_live(cond, j_cond, moved_from=noises[0], floor=0.1, rtol=0, atol=1e-4,
                      name="cond-only latent")
    assert_signal_moved(j_fault, j_cond, floor=1e-3, name="JAX's fault-case latent")
