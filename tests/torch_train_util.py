"""Shared helpers of the port's training tests: the same micro model and
packed batches on both sides (JAX's tree as numpy through
`utils.bridge.params_from_numpy`), and optax's moments beside the port's."""

import dataclasses

import numpy as np
import optax
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.configs import micro_bagel as jmicro_bagel
from bagel_tpu.data.packing import make_synthetic_batch as jmake_synthetic_batch
from bagel_tpu.data.packing import stack_batches as jstack_batches
from bagel_tpu.models.bagel import init_bagel_params as jinit_bagel_params
from bagel_tpu_torch.configs import micro_bagel
from bagel_tpu_torch.models.bagel import PackedTrainBatch
from bagel_tpu_torch.utils.bridge import params_from_numpy


def configs(**llm):
    """(JAX config, port config) of the micro model, with llm overrides."""
    j, t = jmicro_bagel(), micro_bagel()
    if llm:
        j = dataclasses.replace(j, llm=dataclasses.replace(j.llm, **llm))
        t = dataclasses.replace(t, llm=dataclasses.replace(t.llm, **llm))
    return j, t


def jax_params(jcfg, seed=0):
    """fp32 JAX parameters with a random llm2vae head (init zeroes it, which
    would make the MSE gradient of everything below the head vanish)."""
    p = dict(jinit_bagel_params(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32))
    w = p["llm2vae"]["w"]
    noise = jax.random.normal(jax.random.PRNGKey(seed + 1), w.shape)
    p["llm2vae"] = dict(p["llm2vae"], w=0.02 * noise)
    return p


def torch_params(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def jax_batch(jcfg, n=2, seed=0, seq_len=48, n_text=8):
    rng = np.random.default_rng(seed)
    return jstack_batches([
        jmake_synthetic_batch(jcfg, rng, seq_len=seq_len, n_text=n_text,
                              vit_hw=(28, 28), vae_hw=(16, 16))
        for _ in range(n)
    ])


def to_torch_batch(jb) -> PackedTrainBatch:
    return PackedTrainBatch(**{f.name: torch.tensor(np.array(getattr(jb, f.name)))
                               for f in dataclasses.fields(jb)})


def paths(tree, prefix=()):
    """{path tuple: leaf} over dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(paths(v, prefix + (k,)))
    return out


def as_port_layout(path, arr):
    """A JAX leaf in the port's layout (VAE conv kernels HWIO -> OIHW)."""
    arr = np.asarray(arr)
    return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr


def jax_leaves(tree):
    """{path tuple: numpy leaf} of a JAX tree (keys as the port's)."""
    out = {}
    for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in kp)
        out[path] = as_port_layout(path, v)
    return out


def adam_state(opt_state):
    """optax's ScaleByAdamState inside a (masked) chain."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
