"""bagel_tpu_torch.parallel.pipeline (GPipe over the MoT layer stack, gloo
processes) vs bagel_tpu's dense path (tests/test_pipeline.py:47,69), fp32:
the loss within 1e-5 and every gradient within 1e-4 relative per leaf (to
its largest entry) of jax.grad of the vmapped compute_losses, at pp 2 with
B = 2 and 3 microbatches, pp 4 with B = 2, and pp 2 over the chunked
attention (no dense [S, S] mask). `stage_layers` is JAX's reshape."""

import functools

import numpy as np
import pytest
import torch

import jax

from bagel_tpu.parallel.pipeline import stage_layers as jstage_layers
from bagel_tpu.train import step as jstep
from bagel_tpu_torch.parallel.pipeline import stage_layers
from torch_dist_util import run
from torch_train_util import configs, jax_batch, jax_leaves, jax_params, rel_err
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)


def dense_reference(jcfg, jp, jb, noise, **kw):
    """(loss, {path tuple: grad}) of JAX's compute_losses, fp32."""
    with jax.default_matmul_precision("float32"):
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jstep.compute_losses(
            jstep.freeze_stop_gradient(p), jcfg, jb, noise, ce_weight=1.0, mse_weight=1.0,
            **kw)[0]))(jp)
    return float(loss), jax_leaves(grads)


def check_against(got, loss, want):
    assert abs(got["loss"] - loss) <= 1e-5 * abs(loss), (got["loss"], loss)
    for path, g in got["grads"].items():
        ref = want[tuple(int(p) if p.isdigit() else p for p in path.split("/"))]
        if g is None:
            assert not np.abs(ref).max(), path
            continue
        assert rel_err(g, ref) <= 1e-4, (path, rel_err(g, ref))


@functools.lru_cache(maxsize=None)
def _inputs(B):
    """(jcfg, cfg, params, batch, noise, JAX's dense loss and gradients) of B
    rows: the cases of one B share them (the chunked path has the dense
    path's math)."""
    jcfg, cfg = configs(num_hidden_layers=4)
    jp = jax_params(jcfg)
    jb = jax_batch(jcfg, n=B, seed=B, seq_len=128)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(2), jb.vae_patches.shape))
    return (jcfg, cfg, jp, jb, noise) + dense_reference(jcfg, jp, jb, noise)


@pytest.mark.parametrize("pp,B,chunk", [(2, 2, None), (2, 3, None), (4, 2, None), (2, 2, 64)])
def test_pipeline_gradients_match_dense(tmp_path, pp, B, chunk):
    jcfg, cfg, jp, jb, noise, loss, want = _inputs(B)
    got = run("pp_grads", pp, tmp_path, pp=pp, params=jax.tree.map(np.asarray, jp), cfg=cfg,
              batch={k: np.asarray(v) for k, v in vars(jb).items()}, noise=noise,
              attn_chunk=chunk)[0]
    check_against(got, loss, want)


def test_stage_layers_matches_jax():
    jcfg, _ = configs(num_hidden_layers=4)
    jl = jax.tree.map(np.asarray, jax_params(jcfg)["llm"]["layers"])
    got = stage_layers(jax.tree.map(torch.tensor, jl), 2)
    want = jstage_layers(jl, 2)
    for (kp, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                          jax.tree.leaves(jax.tree.map(np.asarray, got))):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(kp))
    with pytest.raises(ValueError, match="not divisible"):
        stage_layers(jax.tree.map(torch.tensor, jl), 3)
