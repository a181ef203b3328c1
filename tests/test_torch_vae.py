"""bagel_tpu_torch vae_decode vs bagel_tpu vae_decode through the weight
bridge (HWIO -> OIHW), CPU fp32. Bar: 1e-4 relative to the output scale."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_vae
from bagel_tpu.models import vae as jvae
from bagel_tpu_torch.models import vae as tvae
from bagel_tpu_torch.utils.bridge import params_from_numpy

from test_torch_qwen2 import randomized
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)


def test_vae_decode_matches_jax():
    cfg = tiny_vae()
    tree = randomized(jvae.init_vae_params(jax.random.PRNGKey(0), cfg, jnp.float32), 5)
    z = np.random.default_rng(6).standard_normal((2, 8, 6, cfg.z_channels)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jvae.vae_decode(jax.tree.map(jnp.asarray, tree), cfg,
                                          jnp.asarray(z), precision="float32"))
    got = tvae.vae_decode(params_from_numpy(tree, "cpu"), cfg, torch.tensor(z)).numpy()
    assert got.shape == want.shape == (2, 16, 12, 3)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-4, err


def test_init_vae_params_tree_matches_jax():
    """Same tree paths and shapes as the JAX init (conv kernels OIHW)."""
    cfg = tiny_vae()
    jtree = jax.tree.map(np.asarray, jvae.init_vae_params(jax.random.PRNGKey(0), cfg))
    ttree = tvae.init_vae_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jtree)
    tleaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), ttree, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, j), (_, t) in zip(jleaves, tleaves):
        want = j.shape if j.ndim != 4 else (j.shape[3], j.shape[2], j.shape[0], j.shape[1])
        assert t.shape == want
