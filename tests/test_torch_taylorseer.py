"""TaylorSeer step caching: bagel_tpu_torch against bagel_tpu, CPU fp32.

The schedule is identical; taylor_update / taylor_eval agree to 1e-6 on
seeded factors with per-branch valid counts; one denoise phase equals the
same schedule split in two with the factors threaded through; and a
`gen_image(enable_taylorseer=True)` latent agrees with JAX's to max-abs
1e-4, with the CFG window first and with a late one (the factors carry
across the phase boundary both ways). The
weights are random with a random llm2vae: a zero velocity head makes the
flow constant and every comparison trivial."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_bagel
from bagel_tpu.data.tokenizer import MockTokenizer as JMockTokenizer
from bagel_tpu.inference import taylorseer as jts
from bagel_tpu.inference.engine import BagelEngine as JEngine
from bagel_tpu.models import bagel as jbagel
from bagel_tpu_torch.data.tokenizer import MockTokenizer
from bagel_tpu_torch.inference import engine as tengine
from bagel_tpu_torch.inference import taylorseer as tts
from bagel_tpu_torch.models import bagel as tbagel
from bagel_tpu_torch.models.qwen2 import kv_cache_init
from bagel_tpu_torch.utils.bridge import params_from_numpy

from asserts import assert_close_live, assert_signal_moved
from test_torch_qwen2 import randomized
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

PROMPT = "a red cube on a blue table"
SHAPE = (32, 32)  # 8 x 8 latent tokens on tiny_bagel
# 11 forwards at shift 3; threshold 3 / first_enhance 2: full steps 0, 1,
# 4, 7, 10, Taylor steps 2, 3, 5, 6, 8, 9; the cond branch's order reaches
# 2 at step 4
TS = dict(num_timesteps=12, timestep_shift=3.0, cfg_text_scale=4.0, cfg_img_scale=1.5,
          enable_taylorseer=True, taylorseer_threshold=3, taylorseer_first_enhance=2)
# CFG on for steps 0-8, then off (9-10); the late window: off for 0-4, then
# on (5-10), where the cfg_text and cfg_img branches join with no factors.
# The JAX engine asserts that the off steps are all on one side of the
# window, so its third phase (off after a late window) is always empty.
WINDOWS = {"two phases": (0.4, 1.0), "late window": (0.0, 0.8)}


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_bagel(visual_und=False)
    tree = randomized(jbagel.init_bagel_params(jax.random.PRNGKey(0), cfg, jnp.float32), 31)
    assert np.abs(tree["llm2vae"]["w"]).max() > 0
    jtok, ttok = JMockTokenizer(cfg.llm.vocab_size), MockTokenizer(cfg.llm.vocab_size)
    jeng = JEngine(jax.tree.map(jnp.asarray, tree), cfg, jtok, jtok.new_token_ids, max_kv=256)
    teng = tengine.BagelEngine(params_from_numpy(tree, "cpu"), cfg, ttok, ttok.new_token_ids,
                               max_kv=256, device="cpu")
    n = (SHAPE[0] // cfg.latent_downsample) * (SHAPE[1] // cfg.latent_downsample)
    noise = np.random.default_rng(32).standard_normal(
        (n, cfg.patch_latent_dim)).astype(np.float32)
    return cfg, jeng, teng, noise


def _contexts(eng):
    ctx = eng.init_context()
    cfg_text, cfg_img = ctx.copy(), ctx.copy()
    ctx = eng.update_context_text(PROMPT, ctx)
    cfg_img = eng.update_context_text(PROMPT, cfg_img)
    return dict(ctx=ctx, cfg_text_precontext=cfg_text, cfg_img_precontext=cfg_img)


@pytest.mark.parametrize("threshold,first_enhance", [(3, 5), (2, 2), (5, 2), (3, 1), (4, 7)])
def test_schedule_identical_to_jax(threshold, first_enhance):
    for steps in (1, 2, 7, 15, 49):
        want = jts.taylorseer_schedule(steps, threshold, first_enhance)
        got = tts.taylorseer_schedule(steps, threshold, first_enhance)
        for name, g, w in zip(want._fields, got, want):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=f"{name}, {steps} steps")


def test_schedule_at_fifty_timesteps():
    """The default schedule of a 50-timestep image: 49 forwards, of which
    19 full (steps 0-4, then every third from 7 to 46)."""
    sch = tts.taylorseer_schedule(49)
    assert np.nonzero(sch.is_full)[0].tolist() == [0, 1, 2, 3, 4] + list(range(7, 47, 3))


@pytest.mark.parametrize("grow", [True, False])
def test_taylor_update_and_eval_match_jax(grow):
    rng = np.random.default_rng(33)
    factors = rng.standard_normal((3, 4, 6, 5)).astype(np.float32)
    feature = rng.standard_normal((4, 6, 5)).astype(np.float32)
    n_valid = np.array([0, 1, 2, 3], np.int32)  # per branch, every count
    for delta in (1.0, 2.0, 3.0):
        jf, jn = jts.taylor_update(jnp.asarray(factors), jnp.asarray(n_valid),
                                   jnp.asarray(feature), jnp.asarray(delta, jnp.float32),
                                   jnp.asarray(grow))
        tf, tn = tts.taylor_update(torch.tensor(factors), torch.tensor(n_valid),
                                   torch.tensor(feature), delta, grow)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6, atol=1e-6)
        for x in (0.0, 1.0, 2.0):
            for nv in (n_valid, np.asarray(jn)):
                want = jts.taylor_eval(jf, jnp.asarray(nv), jnp.asarray(x, jnp.float32))
                got = tts.taylor_eval(tf, torch.tensor(nv), x)
                assert_close_live(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6,
                                  name="extrapolated velocity")
    # a scalar count, as the factors of one branch have it
    jf, jn = jts.taylor_update(jnp.asarray(factors[:, 0]), jnp.asarray(2, jnp.int32),
                               jnp.asarray(feature[0]), jnp.asarray(1.0), jnp.asarray(grow))
    tf, tn = tts.taylor_update(torch.tensor(factors[:, 0]), torch.tensor(2, dtype=torch.int32),
                               torch.tensor(feature[0]), 1.0, grow)
    assert int(tn) == int(jn)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6, atol=1e-6)


def test_phase_split_carries_factor_cache(setup):
    """One phase equals the same schedule split in two with the factors
    threaded through (the CFG phase boundary), and a fresh cache at the
    split does not."""
    cfg, _, teng, _ = setup
    n, pd, steps = 4, cfg.patch_latent_dim, 12
    cache = kv_cache_init(cfg.llm, 1, 256, torch.float32, device="cpu")
    ctx = teng.update_context_text(PROMPT, tengine.GenContext(cache=cache))
    rope = torch.tensor([ctx.rope], dtype=torch.int32)
    lat_pos = torch.zeros((n,), dtype=torch.long)
    x0 = torch.tensor(np.random.default_rng(34).standard_normal((1, n, pd)), dtype=torch.float32)
    ts, dts = tbagel.shifted_timesteps(steps, 1.0)
    sch = tts.taylorseer_schedule(len(ts))
    f0 = torch.zeros((tengine.TAYLORSEER_MAX_ORDER + 1, 1, n, pd))
    nv0 = torch.zeros((1,), dtype=torch.int32)

    def phase(x, f, nv, sl):
        return tengine._denoise_phase_taylorseer(
            teng.params, cfg, x, ctx.cache.k, ctx.cache.v, ctx.cache.length, rope, lat_pos,
            teng._boundary_ids(), ts[sl], dts[sl], sch._make(a[sl] for a in sch), f, nv,
            n_jobs=1, n_branches=1, cfg_text_scale=1.0, cfg_img_scale=1.0,
            cfg_renorm_type="global", cfg_renorm_min=0.0)

    x_full, _, nv_full = phase(x0, f0, nv0, slice(None))
    assert int(nv_full[0]) == 3
    x_a, f_a, nv_a = phase(x0, f0, nv0, slice(0, 7))  # 7: mid Taylor cadence
    x_b, _, _ = phase(x_a, f_a, nv_a, slice(7, steps))
    assert_close_live(x_b.numpy(), x_full.numpy(), moved_from=x0.numpy(), rtol=1e-5,
                      atol=1e-5, name="taylorseer carry")
    x_c, _, _ = phase(x_a, f0, nv0, slice(7, steps))
    assert np.abs(x_full.numpy() - x_c.numpy()).max() > 1e-6


@pytest.mark.parametrize("window", list(WINDOWS))
def test_gen_image_taylorseer_matches_jax(setup, window):
    _, jeng, teng, noise = setup
    kw = dict(cfg_interval=WINDOWS[window], init_noise=noise, return_latent=True, **TS)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jeng.gen_image(SHAPE, **_contexts(jeng), **kw))
        plain = np.asarray(jeng.gen_image(SHAPE, **_contexts(jeng),
                                          **dict(kw, enable_taylorseer=False)))
    got = teng.gen_image(SHAPE, **_contexts(teng), **kw)
    assert got.shape == want.shape == noise.shape and np.isfinite(got).all()
    # the step cache changed the trajectory: Taylor steps really ran
    assert_signal_moved(want, plain, floor=2e-4, name="taylorseer vs all-full latent")
    assert_close_live(got, want, moved_from=noise, floor=0.1, rtol=0, atol=1e-4,
                      name="taylorseer latent")


def test_taylor_steps_run_no_forward(setup, monkeypatch):
    """A Taylor step calls no LLM forward: the 5 full steps of 11 run 5
    llm_extend calls."""
    _, _, teng, noise = setup
    contexts = _contexts(teng)
    calls = []
    real = tengine.qwen2.llm_extend
    monkeypatch.setattr(tengine.qwen2, "llm_extend",
                        lambda *a, **k: calls.append(k["update_cache"]) or real(*a, **k))
    teng.gen_image(SHAPE, **contexts, init_noise=noise, return_latent=True,
                   cfg_interval=WINDOWS["two phases"], **TS)
    sch = tts.taylorseer_schedule(TS["num_timesteps"] - 1, 3, 2)
    assert calls == [False] * int(sch.is_full.sum()) and sch.is_full.sum() == 5
