"""bagel_tpu_torch's train step (loss, AdamW + clip, EMA, schedules) vs
bagel_tpu's on the micro model, fp32 on both sides.

- compute_losses' gradients vs jax.grad: 1e-4 relative per leaf (to the
  leaf's largest entry).
- Three steps of make_train_step vs JAX's jitted step, JAX's flow noise
  handed to the port: parameters, Adam moments, EMA and grad_norm within
  1e-5 relative per leaf. Adam with eps = 1e-15 turns any nonzero gradient
  into a step of about lr, so a leaf whose gradient is mostly rounding
  noise can move apart by up to 2 lr a step. `NOISE_LEAVES` names them:
  the key biases, which shift every logit of a query row by nearly the
  same amount (softmax cancels the shared part, and the gradient is the
  small remainder). They are held to that bound instead (2 lr per step
  with lr > 0), and the test checks that exactly these leaves need it.
- make_lr_schedule equals optax's schedule at counts 0, 1, warmup and total.
- Frozen groups keep their values and hold no moments; the sin-cos tables
  never move; the loss falls over three steps on a fixed batch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.train import step as jstep
from bagel_tpu_torch.train import step as tstep
from torch_train_util import (
    adam_state,
    configs,
    jax_batch,
    jax_leaves,
    jax_params,
    paths,
    rel_err,
    to_torch_batch,
    torch_params,
)
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

NOISE_LEAVES = (("llm", "layers", "attn", "k", "b"), ("vit", "layers", "attn", "k", "b"))
LR = 1e-3
STEPS = 3


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps from fixed weights, with each step's state as numpy."""
    jcfg, cfg = configs()
    jp = jax_params(jcfg)
    jb = jax_batch(jcfg)
    tx = jstep.make_optimizer(jstep.make_lr_schedule(LR, warmup_steps=1), max_grad_norm=1.0)
    state = jstep.init_train_state(jp, tx, use_ema=True)
    with jax.default_matmul_precision("float32"):
        step = jax.jit(jstep.make_train_step(jcfg, tx, ce_weight=1.0, mse_weight=1.0,
                                             ema_decay=0.9))
        keys = [jax.random.PRNGKey(42 + i) for i in range(STEPS)]
        noises, states, metrics = [], [], []
        for key in keys:
            b, n, pd = jb.vae_patches.shape
            noises.append(np.asarray(jax.random.normal(key, (b, n, pd), jnp.float32)))
            state, m = step(state, jb, key)
            states.append(jax.tree.map(np.asarray, state))
            metrics.append({k: float(v) for k, v in m.items()})
    return dict(cfg=cfg, params0=jax.tree.map(np.asarray, jp), batch=jb, noises=noises,
                states=states, metrics=metrics)


def _torch_state(jax_run, frozen=()):
    cfg = jax_run["cfg"]
    params = torch_params(jax_run["params0"])
    tx = tstep.make_optimizer(tstep.make_lr_schedule(LR, warmup_steps=1), max_grad_norm=1.0,
                              frozen=frozen)
    state = tstep.init_train_state(params, tx, use_ema=True)
    step = tstep.make_train_step(cfg, tx, ce_weight=1.0, mse_weight=1.0, ema_decay=0.9,
                                 frozen=frozen)
    return state, step


def test_compute_losses_gradients_match_jax(jax_run):
    jcfg, cfg = configs()
    jb = jax_run["batch"]
    noise = jax_run["noises"][0]
    with jax.default_matmul_precision("float32"):
        (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
            lambda p: jstep.compute_losses(p, jcfg, jb, jnp.asarray(noise), 1.0, 1.0),
            has_aux=True))(jax.tree.map(jnp.asarray, jax_run["params0"]))
    params = torch_params(jax_run["params0"])
    for t in paths(params).values():
        t.requires_grad_(True)
    grads, m = tstep.grad_step(params, cfg, to_torch_batch(jb), torch.tensor(noise),
                               ce_weight=1.0, mse_weight=1.0)
    assert abs(float(m["loss"]) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for k in ("ce", "mse"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    want = jax_leaves(jgrads)
    got = paths(grads)
    assert set(got) == set(want)
    for path, g in got.items():
        if np.abs(want[path]).max() == 0:
            assert g is None or not g.abs().max(), path
            continue
        assert rel_err(g.numpy(), want[path]) <= 1e-4, (path, rel_err(g.numpy(), want[path]))


def test_three_steps_match_jax(jax_run):
    state, step = _torch_state(jax_run)
    batch = to_torch_batch(jax_run["batch"])
    noisy = set()
    for i in range(STEPS):
        state, m = step(state, batch, noise=torch.tensor(jax_run["noises"][i]))
        want = jax_run["states"][i]
        wm = jax_run["metrics"][i]
        assert state.step == i + 1 and int(want.step) == i + 1
        assert abs(float(m["grad_norm"]) - wm["grad_norm"]) <= 1e-5 * wm["grad_norm"]
        assert abs(float(m["loss"]) - wm["loss"]) <= 1e-5 * abs(wm["loss"])
        adam = adam_state(want.opt_state)
        assert state.opt_state["count"] == int(adam.count)
        trees = (
            ("params", state.params, jax_leaves(want.params)),
            ("ema", state.ema_params, jax_leaves(want.ema_params)),
            ("mu", state.opt_state["mu"], jax_leaves(adam.mu)),
            ("nu", state.opt_state["nu"], jax_leaves(adam.nu)),
        )
        for name, tree, ref in trees:
            for path, t in paths(tree).items():
                if t is None:  # a frozen buffer: optax keeps zero moments there
                    assert name in ("mu", "nu") and not np.abs(ref[path]).max(), path
                    continue
                err = rel_err(t.detach().numpy(), ref[path])
                if err > 1e-5:
                    noisy.add(path)
                    assert path in NOISE_LEAVES, (name, i, path, err)
                    if name in ("params", "ema"):  # steps 2 and 3 have lr > 0
                        bound = 2 * LR * i * (1 + 1e-3)
                        assert np.abs(t.detach().numpy() - ref[path]).max() <= bound, (name, path)
    assert noisy == set(NOISE_LEAVES)


@pytest.mark.parametrize("kind", ["constant", "cosine"])
def test_lr_schedule_matches_optax(kind):
    lr, warmup, total = 3e-4, 7, 40
    want = jstep.make_lr_schedule(lr, warmup, total, kind, min_lr=1e-6)
    got = tstep.make_lr_schedule(lr, warmup, total, kind, min_lr=1e-6)
    for count in (0, 1, 3, warmup, warmup + 1, 20, total, total + 5):
        assert np.float32(got(count)) == np.float32(want(jnp.int32(count))), (kind, count)
    assert got(0) == 0.0  # optax reads the count before the update: no step at 0


def test_frozen_groups_unchanged_and_without_moments(jax_run):
    state, step = _torch_state(jax_run, frozen=("vit", "vae"))
    before = {k: t.detach().clone() for k, t in paths(state.params).items()}
    batch = to_torch_batch(jax_run["batch"])
    for i in range(2):
        state, _ = step(state, batch, noise=torch.tensor(jax_run["noises"][i]))
    moved = {k for k, t in paths(state.params).items() if not torch.equal(t, before[k])}
    frozen = {k for k in before if k[0] in ("vit", "vae") + tstep.FROZEN_BUFFERS}
    assert not moved & frozen
    assert {k for k in before if k[0] == "llm"} <= moved
    for tree in (state.opt_state["mu"], state.opt_state["nu"]):
        for path, t in paths(tree).items():
            assert (t is None) == (path[0] in frozen_groups(frozen)), path
    for path in frozen:
        assert not state.params[path[0]] is None
        t = paths(state.params)[path]
        assert not t.requires_grad


def frozen_groups(frozen_paths):
    return {p[0] for p in frozen_paths}


def test_buffer_tables_never_move(jax_run):
    state, step = _torch_state(jax_run)
    tables = {k: state.params[k].detach().clone() for k in tstep.FROZEN_BUFFERS}
    batch = to_torch_batch(jax_run["batch"])
    for i in range(2):
        state, _ = step(state, batch, noise=torch.tensor(jax_run["noises"][i]))
    for k, t in tables.items():
        assert torch.equal(state.params[k], t), k
        assert state.opt_state["mu"][k] is None and state.opt_state["nu"][k] is None


def test_loss_decreases_on_fixed_batch(jax_run):
    state, step = _torch_state(jax_run)
    batch = to_torch_batch(jax_run["batch"])
    gen = torch.Generator().manual_seed(42)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch, gen)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1]) and float(m["grad_norm"]) > 0
    assert losses[-1] < losses[0], losses
    assert state.step == STEPS
