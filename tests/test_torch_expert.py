"""bagel_tpu_torch.parallel.expert (the MoT experts over 2 gloo processes)
vs bagel_tpu's dense dual-expert path (tests/test_expert.py:81-94), fp32:
the loss within 1e-5 and every gradient, unsharded, within 1e-4 relative per
leaf of jax.grad, with freeze_und off and on, the moe variant (shared
attention), and two rows over the chunked attention. The gen expert is
moved off its und-copy init so that a routing fault cannot cancel out.
`split_expert_layers` stacks as JAX's; the refused forms raise."""

import numpy as np
import pytest
import torch

import jax

from bagel_tpu.parallel.expert import split_expert_layers as jsplit
from bagel_tpu_torch.parallel.expert import split_expert_layers
from test_torch_pipeline import check_against, dense_reference
from torch_dist_util import run
from torch_train_util import configs, jax_batch, jax_params
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)


def _inputs(B=1, seed=0, **llm):
    jcfg, cfg = configs(num_hidden_layers=3, **llm)
    jp = jax_params(jcfg)
    layers = dict(jp["llm"]["layers"])
    for name, key in (("attn_gen", 11), ("mlp_gen", 13)):
        if name in layers:
            layers[name] = jax.tree.map(
                lambda a: a + 0.01 * jax.random.normal(jax.random.PRNGKey(key), a.shape, a.dtype),
                layers[name])
    jp["llm"] = dict(jp["llm"], layers=layers)
    jb = jax_batch(jcfg, n=B, seed=seed, seq_len=128)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(2), jb.vae_patches.shape))
    return jcfg, cfg, jp, jb, noise


CASES = {"mot": dict(), "mot-freeze_und": dict(llm=dict(freeze_und=True)),
         "moe": dict(llm=dict(layer_module="moe"), seed=3),
         "batched-chunked": dict(B=2, seed=5, chunk=64)}


@pytest.mark.parametrize("case", list(CASES))
def test_expert_parallel_gradients_match_dense(tmp_path, case):
    c = CASES[case]
    jcfg, cfg, jp, jb, noise = _inputs(c.get("B", 1), c.get("seed", 0), **c.get("llm", {}))
    kw = {"attn_chunk": c["chunk"]} if "chunk" in c else {}
    loss, want = dense_reference(jcfg, jp, jb, noise, **kw)
    got = run("ep_grads", 2, tmp_path, params=jax.tree.map(np.asarray, jp), cfg=cfg,
              batch={k: np.asarray(v) for k, v in vars(jb).items()}, noise=noise, **kw)[0]
    check_against(got, loss, want)


def test_split_expert_layers_matches_jax():
    jcfg, _ = configs()
    jl = jax.tree.map(np.asarray, jax_params(jcfg)["llm"]["layers"])
    stacked, shared = split_expert_layers(jax.tree.map(torch.tensor, jl))
    jstacked, jshared = jsplit(jl)
    assert sorted(stacked) == sorted(jstacked) and sorted(shared) == sorted(jshared)
    for a, b in zip(jax.tree.leaves(jstacked), jax.tree.leaves(jax.tree.map(np.asarray, stacked))):
        np.testing.assert_array_equal(np.asarray(a), b)
    dense = {k: v for k, v in jl.items() if not k.endswith("_gen")}
    with pytest.raises(ValueError, match="dual-expert"):
        split_expert_layers(jax.tree.map(torch.tensor, dense))
