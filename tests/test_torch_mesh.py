"""bagel_tpu_torch.parallel.mesh vs bagel_tpu.parallel.mesh.

- `param_pspec` gives every leaf of micro_bagel the spec JAX's gives it,
  with and without `pipeline_axis`.
- The init that shards each leaf as it is drawn keeps what sharding the
  whole tree keeps (fsdp and ep, 2 gloo processes).
- One sharded train step on 4 gloo processes, at meshes (2,2,1), (1,2,2)
  and (2,1,2), against JAX's step on a 4-device mesh of the same shape
  (tests/test_train.py:143), fp32 both sides, a micro model with 4 heads and
  2 KV heads (so tp = 2 splits whole heads): the global loss within 1e-5
  relative; the reduced gradients, unsharded, within 1e-4 relative per leaf
  (to its largest entry) of jax.grad; the parameters, EMA and Adam's first
  moment after one AdamW + EMA update (lr 1e-3, no warmup) within 1e-5
  relative per leaf. Adam's first step is lr g / (|g| + 1e-15): the key
  biases' gradients are mostly rounding noise (tests/test_torch_train_step.py:
  NOISE_LEAVES), and where |g| < 1e-11 the eps moves the step by more than
  1e-4 of lr; those entries are held to 2 lr (the most two signs can part).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bagel_tpu.parallel import mesh as jmesh
from bagel_tpu.train import step as jstep
from bagel_tpu_torch.parallel.mesh import param_pspec
from torch_dist_util import run
from torch_train_util import adam_state, configs, jax_batch, jax_leaves, jax_params, rel_err

LR = 1e-3
EMA = 0.9
NOISE_LEAVES = (("llm", "layers", "attn", "k", "b"), ("llm", "layers", "attn_gen", "k", "b"),
                ("vit", "layers", "attn", "k", "b"))


def _key(path: str) -> tuple:
    return tuple(int(p) if p.isdigit() else p for p in path.split("/"))


@pytest.mark.parametrize("pipeline_axis", [None, "fsdp"])
def test_param_pspec_matches_jax(pipeline_axis):
    jcfg, _ = configs()
    jp = jax_params(jcfg)
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(leaves) > 50
    for kp, leaf in leaves:
        want = tuple(jmesh.param_pspec(kp, leaf, pipeline_axis))
        assert param_pspec(kp, leaf, pipeline_axis) == want, (kp, want)
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        assert param_pspec(path, leaf, pipeline_axis) == want, path


@pytest.mark.parametrize("mesh", [((1, 2, 1), ("dp", "fsdp", "tp"), None),
                                  ((2,), ("ep",), "ep")], ids=["fsdp", "ep"])
def test_init_places_each_leaf_as_drawn(tmp_path, mesh):
    """The driver's init under a mesh (each leaf drawn whole and sharded at
    once) keeps what sharding the whole tree keeps, on 2 gloo processes."""
    _, cfg = configs()
    for r in run("placed_init", 2, tmp_path, cfg=cfg, shape=mesh[0], axes=mesh[1],
                 expert_axis=mesh[2]):
        assert r["paths"] and r["equal"] and r["shapes"] and r["sharded"] and r["leaves"] > 50, r


@pytest.fixture(scope="module")
def inputs():
    """The micro model (4 heads over 2 KV heads), two rows, JAX's flow noise
    and JAX's gradients of the unsharded loss (the same on every mesh)."""
    jcfg, cfg = configs(num_attention_heads=4, num_key_value_heads=2)
    jp = jax_params(jcfg)
    jb = jax_batch(jcfg, n=2)
    key = jax.random.PRNGKey(42)
    noise = jax.random.normal(key, jb.vae_patches.shape, jnp.float32)
    with jax.default_matmul_precision("float32"):
        grads = jax.jit(jax.grad(lambda p: jstep.compute_losses(
            jstep.freeze_stop_gradient(p), jcfg, jb, noise, ce_weight=1.0,
            mse_weight=1.0)[0]))(jp)
    return jcfg, cfg, jp, jb, key, noise, jax_leaves(grads)


def _jax_step(shape, jcfg, jp, jb, key, noise, grads):
    mesh = jmesh.make_mesh(shape, devices=jax.devices()[:4])
    with jax.default_matmul_precision("float32"):
        with mesh:
            tx = jstep.make_optimizer(jstep.make_lr_schedule(LR, warmup_steps=0))
            state = jstep.init_train_state(jmesh.shard_params(mesh, jp), tx, use_ema=True)
            step = jax.jit(jstep.make_train_step(jcfg, tx, ce_weight=1.0, mse_weight=1.0,
                                                 ema_decay=EMA))
            state, m = step(state, jmesh.shard_batch(mesh, jb), key)
    return dict(noise=np.asarray(noise), loss=float(m["loss"]), grads=grads,
                params=jax_leaves(state.params), ema=jax_leaves(state.ema_params),
                mu=jax_leaves(adam_state(state.opt_state).mu))


@pytest.mark.parametrize("shape", [(2, 2, 1), (1, 2, 2), (2, 1, 2)])
def test_sharded_train_step_matches_jax(tmp_path, inputs, shape):
    jcfg, cfg, jp, jb = inputs[:4]
    want = _jax_step(shape, jcfg, jp, jb, *inputs[4:])
    got = run("train_step", 4, tmp_path, shape=shape,
              params=jax.tree.map(np.asarray, jp), cfg=cfg,
              batch={k: np.asarray(v) for k, v in vars(jb).items()},
              noise=want["noise"], lr=LR, ema_decay=EMA)
    for r in got[1:]:  # every process reports the same global numbers
        assert r["loss"] == got[0]["loss"] and r["grad_norm"] == got[0]["grad_norm"]
    got = got[0]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), (got["loss"], want)
    noisy = set()
    for path, g in got["grads"].items():
        ref = want["grads"][_key(path)]
        if g is None:
            assert not np.abs(ref).max(), path
            continue
        assert rel_err(g, ref) <= 1e-4, (path, rel_err(g, ref))
    for tree in ("params", "ema", "mu"):
        for path, x in got[tree].items():
            if x is None:
                continue
            w, g = want[tree][_key(path)], want["grads"][_key(path)]
            if tree == "mu":
                assert rel_err(x, w) <= 1e-4, (tree, path, rel_err(x, w))
                continue
            # Adam's first step is lr g / (|g| + eps): where |g| < 1e-11 eps
            # (1e-15) moves it by more than 1e-4 of lr, and either side's
            # rounding of g shows
            bound = 2 * LR * (1 if tree == "params" else 1 - EMA)
            free = (np.abs(g) < 1e-11) | (_key(path) in NOISE_LEAVES)
            diff = np.abs(x - w)
            assert (diff[free] <= bound * 1.01).all(), (tree, path)
            err = diff[~free].max(initial=0) / max(np.abs(w).max(), 1e-30)
            assert err <= 1e-5, (tree, path, err)
