"""Checkpoint I/O of bagel_tpu_torch vs bagel_tpu (no checkpoint in the
repository: seeded trees stand in for one).

Bars: bagel_tpu's `export_bagel` / `export_vae` of seeded params, read by
the port's `convert_bagel` / `convert_vae`, equal `params_from_numpy` of the
same tree (bit for bit; the sin-cos tables, which both make again from the
config, within float rounding); the port's `export_bagel` equal to
bagel_tpu's; a `save_checkpoint_dir` / `load_checkpoint_dir` round trip in
a temporary directory, bf16 included; `export_checkpoint`'s sidecars.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_bagel
from bagel_tpu.models.bagel import init_bagel_params
from bagel_tpu.utils import convert as jconvert
from bagel_tpu_torch.utils import convert
from bagel_tpu_torch.utils.bridge import params_from_numpy, params_to
from bagel_tpu_torch.utils.export_hf import export_checkpoint

from test_torch_qwen2 import randomized

TABLES = {"vit_pos_embed", "latent_pos_embed"}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        if k in TABLES:
            torch.testing.assert_close(g[k], w[k], rtol=0, atol=1e-6)
        else:
            assert torch.equal(g[k], w[k]), k


@pytest.fixture(scope="module")
def tree():
    cfg = tiny_bagel()
    params = init_bagel_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    tree = randomized(params, 12)
    for k in TABLES:  # fixed tables: a loader makes them again from the config
        tree[k] = np.asarray(params[k])
    return cfg, tree


def test_jax_export_reads_back_as_bridged_params(tree):
    cfg, params = tree
    params = dict(params)
    vae = params.pop("vae")
    jparams = jax.tree.map(jnp.asarray, params)
    got = convert.convert_bagel(jconvert.export_bagel(jparams, cfg), cfg)
    _assert_trees_equal(got, params_from_numpy(params, "cpu"))
    got_vae = convert.convert_vae(jconvert.export_vae(jax.tree.map(jnp.asarray, vae), cfg.vae),
                                  cfg.vae)
    _assert_trees_equal(got_vae, params_from_numpy(vae, "cpu"))  # conv kernels OIHW


def test_port_export_equals_jax_export(tree):
    cfg, params = tree
    want = jconvert.export_bagel(jax.tree.map(jnp.asarray, params), cfg)
    got = convert.export_bagel(params_from_numpy(params, "cpu"), cfg)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    want_vae = jconvert.export_vae(jax.tree.map(jnp.asarray, params["vae"]), cfg.vae)
    got_vae = convert.export_vae(params_from_numpy(params["vae"], "cpu"), cfg.vae)
    assert got_vae.keys() == want_vae.keys()
    for k in want_vae:
        np.testing.assert_array_equal(got_vae[k].numpy(), np.asarray(want_vae[k]), err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_save_and_load_checkpoint_dir(tree, tmp_path, dtype):
    cfg, params = tree
    tparams = params_from_numpy(params, "cpu", dtype=dtype)
    convert.save_checkpoint_dir(tparams, cfg, str(tmp_path))
    for name in ("model", "ema", "ae"):
        assert (tmp_path / f"{name}.safetensors").is_file()
    back = convert.load_checkpoint_dir(str(tmp_path), cfg)
    # the tables are made again in f32 from the config
    back = {k: (v.to(dtype) if k in TABLES else v) for k, v in back.items()}
    _assert_trees_equal(back, tparams)
    moved = params_to(back, "cpu", dtype=torch.float32)
    assert moved["llm"]["embed"].dtype == torch.float32


def test_the_jax_loader_reads_the_port_checkpoint(tree, tmp_path):
    cfg, params = tree
    convert.save_checkpoint_dir(params_from_numpy(params, "cpu"), cfg, str(tmp_path))
    back = jconvert.load_checkpoint_dir(str(tmp_path), cfg)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                 jax.tree.leaves(back)):
        tol = 1e-6 if any(getattr(p, "key", None) in TABLES for p in path) else 0
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def test_export_checkpoint_copies_sidecars(tree, tmp_path):
    cfg, params = tree
    src = tmp_path / "src"
    src.mkdir()
    (src / "vocab.json").write_text("{}")
    (src / "unrelated.txt").write_text("x")
    out = export_checkpoint(params_from_numpy(params, "cpu"), cfg, str(tmp_path / "out"),
                            tokenizer_src=str(src), source="seeded")
    files = {p.name for p in (tmp_path / "out").iterdir()}
    assert {"model.safetensors", "ema.safetensors", "ae.safetensors", "vocab.json",
            "export_meta.json"} <= files and "unrelated.txt" not in files
    meta = json.loads((tmp_path / "out" / "export_meta.json").read_text())
    assert meta == {"source": "seeded"} and out.endswith("out")
