"""tools/orbax_to_torch.py: a bagel_tpu (Orbax) training state converted into
bagel_tpu_torch's checkpoint format, then resumed, finetuned from and
exported by the port (micro preset, fp32, the JAX side under
jax.default_matmul_precision("float32") on the CPU).

- Full state: two JAX steps with the VAE frozen (moments nonzero, EMA !=
  params, count 2, the masked moments absent), saved by bagel_tpu's
  save_checkpoint with data_status and config. The port's
  restore_checkpoint gives every leaf of params, EMA, mu and nu bit-equal
  to JAX's after the layout map, the same step, count and data_status;
  one more step on each side (JAX's flow noise handed over) stays within
  test_torch_train_step.py's bounds: 1e-5 relative per leaf, its
  NOISE_LEAVES within 2 lr. Each Orbax read of the conversion restores one
  leaf.
- The same state saved sharded over the 8 CPU devices converts to the same
  bytes; a state with the VAE unfrozen gives its conv leaves' params, EMA
  and moments OIHW.
- The drivers: bagel_tpu's driver saves at step 2; the port's driver
  resumes the converted state at step 2 and packs the step-3 batch that
  bagel_tpu's own --auto_resume packs (token ids and data_indexes), with a
  finite loss; --resume_model_only --finetune_from_ema takes JAX's EMA.
  (Set-up time only: the JAX driver gets the port's weight draw and one
  device, and its resumed run's update, which does not change what it
  packs, is not compiled.)
- The port's export of the converted state equals bagel_tpu's export of
  the Orbax state, tensor for tensor.
- Refusals: a committed output step; an opt_state without one Adam state;
  the port's restore, driver (--auto_resume, --resume_from) and export
  given the Orbax directory itself (each names the converter).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

import jax
import jax.numpy as jnp
import optax
import orbax.checkpoint as ocp
from orbax.checkpoint import type_handlers

from bagel_tpu.configs import config_to_json
from bagel_tpu.train import checkpoint as jckpt
from bagel_tpu.train import step as jstep
from bagel_tpu.utils.export_hf import export_checkpoint as jexport
from bagel_tpu_torch.configs import bagel_config_from_json
from bagel_tpu_torch.models.bagel import init_bagel_params
from bagel_tpu_torch.train import checkpoint as tckpt
from bagel_tpu_torch.train import step as tstep
from bagel_tpu_torch.utils.export_hf import export_from_checkpoint

from test_torch_train_step import LR, NOISE_LEAVES
from torch_dist_util import REPO
from torch_train_util import (
    adam_state,
    configs,
    jax_batch,
    jax_leaves,
    paths,
    rel_err,
    to_torch_batch,
    torch_params,
)
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

sys.path.insert(0, os.path.join(REPO, "tools"))
import orbax_to_torch  # noqa: E402

FROZEN = ("vae",)
STATUS = {0: {"t2i_pretrain": {0: [3, 1, 4]}}}


def _jax_tree(cfg, seed=0):
    """Micro weights in JAX's layout as numpy, drawn by the port's init
    (JAX's eager init takes ~20 s on the CPU) and taken back to JAX's
    layout (the conv kernels OIHW -> HWIO), with a random llm2vae head."""
    def back(node):
        if isinstance(node, dict):
            return {k: back(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [back(v) for v in node]
        a = node.detach().numpy()
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a

    tree = back(init_bagel_params(torch.Generator().manual_seed(seed), cfg, torch.float32,
                                  device="cpu"))
    w = tree["llm2vae"]["w"]
    tree["llm2vae"]["w"] = (0.02 * np.random.default_rng(seed).standard_normal(w.shape)).astype(
        np.float32)
    return tree


def _jax_params(cfg, seed=0):
    return jax.tree.map(jnp.asarray, _jax_tree(cfg, seed))


def _sharded(tree):
    """Every leaf over the 8 CPU devices: split on its first axis that 8
    divides, else replicated."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("x",))

    def sharding(x):
        spec = [None] * x.ndim
        for i, n in enumerate(x.shape):
            if n % 8 == 0:
                spec[i] = "x"
                break
        return jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(*spec))

    return jax.jit(lambda t: t, out_shardings=jax.tree.map(sharding, tree))(tree)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two JAX steps with the VAE frozen, saved plain and sharded; the third
    step's state and noise; both saves converted (the plain one under a spy
    on Orbax's array reads)."""
    tmp = tmp_path_factory.mktemp("orbax")
    jcfg, cfg = configs()
    jp = _jax_params(cfg)
    jb = jax_batch(jcfg)
    tx = jstep.make_optimizer(jstep.make_lr_schedule(LR, warmup_steps=1), max_grad_norm=1.0,
                              frozen=FROZEN)
    state = jstep.init_train_state(jp, tx, use_ema=True)
    with jax.default_matmul_precision("float32"):
        step = jax.jit(jstep.make_train_step(jcfg, tx, ce_weight=1.0, mse_weight=1.0,
                                             ema_decay=0.9, frozen=FROZEN))
        noises = []
        for i in range(3):
            key = jax.random.PRNGKey(42 + i)
            b, n, pd = jb.vae_patches.shape
            noises.append(np.asarray(jax.random.normal(key, (b, n, pd), jnp.float32)))
            state, _ = step(state, jb, key)
            if i == 1:
                saved = jax.tree.map(np.asarray, state)
                jckpt.save_checkpoint(str(tmp / "jax"), 2, state, STATUS, jcfg)
                jckpt.save_checkpoint(str(tmp / "jax_sharded"), 2, _sharded(state), STATUS, jcfg)
    reads = []
    deserialize = type_handlers.NumpyHandler.deserialize

    async def spy(self, infos, args=None):
        reads.append([i.name for i in infos])
        return await deserialize(self, infos, args)

    type_handlers.NumpyHandler.deserialize = spy
    try:
        plain = orbax_to_torch.convert(str(tmp / "jax" / "0000002"), str(tmp / "port"))
    finally:
        type_handlers.NumpyHandler.deserialize = deserialize
    sharded = orbax_to_torch.convert(str(tmp / "jax_sharded"), str(tmp / "port_sharded"))
    return dict(tmp=tmp, cfg=cfg, params0=jax.tree.map(np.asarray, jp), batch=jb, noise=noises[2],
                saved=saved, next=jax.tree.map(np.asarray, state), plain=plain, sharded=sharded,
                reads=reads)


def _port_state(run):
    tx = tstep.make_optimizer(tstep.make_lr_schedule(LR, warmup_steps=1), max_grad_norm=1.0,
                              frozen=FROZEN)
    return tstep.init_train_state(torch_params(run["params0"]), tx, use_ema=True), tx


def _trees(state, jstate):
    adam = adam_state(jstate.opt_state)
    return (("params", state.params, jax_leaves(jstate.params)),
            ("ema", state.ema_params, jax_leaves(jstate.ema_params)),
            ("mu", state.opt_state["mu"], jax_leaves(adam.mu)),
            ("nu", state.opt_state["nu"], jax_leaves(adam.nu)))


def test_full_state_restores_bit_equal_and_steps_with_jax(run):
    state, tx = _port_state(run)
    state, status = tckpt.restore_checkpoint(run["plain"], state)
    saved = run["saved"]
    assert state.step == int(saved.step) == 2
    assert state.opt_state["count"] == int(adam_state(saved.opt_state).count) == 2
    assert status == STATUS
    moved = 0
    for name, tree, ref in _trees(state, saved):
        for path, t in paths(tree).items():
            if t is None:  # frozen: optax masks it, the port holds no moment
                assert name in ("mu", "nu") and path[0] in FROZEN + tstep.FROZEN_BUFFERS, path
                continue
            assert np.array_equal(t.detach().numpy(), ref[path]), (name, path)
            moved += name in ("mu", "nu") and bool(np.abs(ref[path]).max() > 0)
    assert moved > 0  # the moments are live
    assert any(not np.array_equal(a, b) for a, b in zip(jax.tree.leaves(saved.params),
                                                        jax.tree.leaves(saved.ema_params)))

    step = tstep.make_train_step(run["cfg"], tx, ce_weight=1.0, mse_weight=1.0, ema_decay=0.9,
                                 frozen=FROZEN)
    state, _ = step(state, to_torch_batch(run["batch"]), noise=torch.tensor(run["noise"]))
    assert state.step == 3 and state.opt_state["count"] == 3
    for name, tree, ref in _trees(state, run["next"]):
        for path, t in paths(tree).items():
            if t is None:
                continue
            err = rel_err(t.detach().numpy(), ref[path])
            if err > 1e-5:
                assert path in NOISE_LEAVES, (name, path, err)
                if name in ("params", "ema"):
                    gap = np.abs(t.detach().numpy() - ref[path]).max()
                    assert gap <= 2 * LR * (1 + 1e-3), (name, path, gap)


def test_each_orbax_read_restores_one_leaf(run):
    with open(os.path.join(run["plain"], "state", "state.json")) as f:
        assert json.load(f) == {"step": 2, "count": 2, "trees": ["ema", "mu", "nu", "params"]}
    leaves = 0
    for name in ("params", "ema", "mu", "nu"):
        with tckpt._open(os.path.join(run["plain"], "state"), name) as f:
            leaves += len(list(f.keys()))
    assert all(len(names) == 1 for names in run["reads"])
    # every leaf once, then Adam's and the schedule's counts and the step
    assert len(run["reads"]) == leaves + 3
    assert len({n[0] for n in run["reads"]}) == leaves + 3


def test_sharded_state_converts_to_the_same_bytes(run):
    jax_dir = run["tmp"] / "jax_sharded" / "0000002" / "state"
    assert any(p.startswith("ocdbt.process_") for p in os.listdir(jax_dir))
    for sub in ("state/params.safetensors", "state/ema.safetensors", "state/mu.safetensors",
                "state/nu.safetensors", "state/state.json", "data_status.json", "config.json"):
        with open(os.path.join(run["plain"], sub), "rb") as a, \
                open(os.path.join(run["sharded"], sub), "rb") as b:
            assert a.read() == b.read(), sub


def test_conv_leaves_come_out_oihw(tmp_path):
    """The VAE unfrozen (a state of the VAE's tree alone): its conv
    kernels' params, EMA and moments (live values, not zeros) all HWIO ->
    OIHW."""
    _, cfg = configs()
    tx = jstep.make_optimizer(jstep.make_lr_schedule(LR, warmup_steps=1))
    state = jstep.init_train_state({"vae": _jax_params(cfg)["vae"]}, tx, use_ema=True)
    rng = np.random.default_rng(0)
    live = lambda t: jax.tree.map(  # noqa: E731
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)), t)
    adam = adam_state(state.opt_state)
    state.opt_state = jax.tree.map(
        lambda s: s._replace(mu=live(s.mu), nu=live(s.nu))
        if isinstance(s, optax.ScaleByAdamState) else s, state.opt_state,
        is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
    state.ema_params = live(state.ema_params)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 5, state)
    out = orbax_to_torch.convert(str(tmp_path / "jax"), str(tmp_path / "port"))
    adam = adam_state(state.opt_state)
    convs = 0
    for name, jtree in (("params", state.params), ("ema", state.ema_params), ("mu", adam.mu),
                        ("nu", adam.nu)):
        tree = tckpt.load_tree(out, name)
        for path, x in jax_leaves(jtree).items():
            if path[0] != "vae":
                continue
            got = paths(tree)[path].numpy()
            assert np.array_equal(got, x), (name, path)
            if x.ndim == 4:
                src = np.asarray(paths(jax.tree.map(np.asarray, jtree))[path])
                assert got.shape == (src.shape[3], src.shape[2], src.shape[0], src.shape[1])
                convs += 1
    assert convs >= 4 * 10


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_torch_train_driver.py's corpus, registered in both
    packages."""
    import io

    import pyarrow as pa
    import pyarrow.parquet as pq
    import yaml
    from PIL import Image

    from bagel_tpu.data.datasets import register_dataset_info as jregister
    from bagel_tpu_torch.data.datasets import register_dataset_info

    root = tmp_path_factory.mktemp("orbax_driver_data")
    rng = np.random.default_rng(0)
    (root / "t2i").mkdir()
    rows = []
    for i in range(6):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (48, 40, 3), dtype=np.uint8), "RGB").save(buf, "PNG")
        rows.append({"image": buf.getvalue(), "captions": json.dumps({"cap": f"picture {i}"})})
    pq.write_table(pa.Table.from_pylist(rows), root / "t2i" / "p0.parquet", row_group_size=3)
    for register in (jregister, register_dataset_info):
        register("t2i_pretrain", "toy_t2i", data_dir=str(root / "t2i"))
    (root / "data.yaml").write_text(yaml.safe_dump({"t2i_pretrain": {
        "dataset_names": ["toy_t2i"], "weight": 1.0, "is_mandatory": True,
        "num_used_data": [1],
        "image_transform_args": {"max_image_size": 32, "min_image_size": 16,
                                 "image_stride": 4, "max_pixels": 32 * 32},
    }}))
    return root


def _args(corpus, ckpt_dir, *extra):
    return ["--preset", "micro", "--mock_tokenizer", "--dataset_config",
            str(corpus / "data.yaml"), "--ckpt_dir", str(ckpt_dir), "--save_every", "2",
            "--log_every", "1", "--expected_num_tokens", "200", "--max_num_tokens", "260",
            "--max_num_tokens_per_sample", "250", "--warmup_steps", "1", "--ce_weight", "1.0",
            *extra]


def _recording(module, monkeypatch):
    """The packed batches and data_indexes of `module`'s driver loop."""
    seen = dict(batches=[], indexes=[])
    stack, update = module.stack_batches, module.update_data_status

    def stack_batches(batches):
        out = stack(batches)
        seen["batches"].append(np.asarray(out.text_ids))
        return out

    def update_data_status(status, data_indexes):
        seen["indexes"].append(json.loads(json.dumps(data_indexes)))
        return update(status, data_indexes)

    monkeypatch.setattr(module, "stack_batches", stack_batches)
    monkeypatch.setattr(module, "update_data_status", update_data_status)
    return seen


def test_port_driver_resumes_a_converted_jax_run(corpus, tmp_path, monkeypatch):
    from bagel_tpu.parallel import mesh as jmesh
    from bagel_tpu.train import driver as jdriver
    from bagel_tpu_torch.train import driver

    # set-up time: the JAX driver's eager init takes ~20 s a run here (the
    # port's draw instead), and its default mesh over the 8 CPU devices
    # doubles its compile (one device instead)
    monkeypatch.setattr(jdriver, "init_bagel_params", lambda key, cfg, dtype: _jax_params(
        bagel_config_from_json(config_to_json(cfg))))
    monkeypatch.setattr(jdriver, "make_mesh",
                        lambda shape: jmesh.make_mesh((1, 1, 1), jax.devices()[:1]))
    jax_ck = tmp_path / "jax"
    jdriver.main(_args(corpus, jax_ck, "--total_steps", "2"))
    assert sorted(os.listdir(jax_ck)) == ["0000002"]
    for orbax in (["--auto_resume"], ["--resume_from", str(jax_ck / "0000002")]):
        with pytest.raises(ValueError, match="tools/orbax_to_torch.py --ckpt"):
            driver.main(["--device", "cpu"] + _args(corpus, jax_ck, "--total_steps", "3", *orbax))
    converted = orbax_to_torch.main(["--ckpt", str(jax_ck), "--out", str(tmp_path / "port")])
    want = _recording(jdriver, monkeypatch)
    # JAX's --auto_resume packs step 3; its update does not change what it
    # packs and would only compile (set-up time): it leaves the state as it is
    monkeypatch.setattr(jdriver, "make_grad_and_apply", lambda *a: (
        lambda params, batch, noise: (None, {"loss": 0.0, "ce": 0.0}),
        lambda state, grads: state))
    jdriver.main(_args(corpus, jax_ck, "--total_steps", "3", "--auto_resume"))
    got = _recording(driver, monkeypatch)
    state, history = driver.main(["--device", "cpu"] + _args(
        corpus, tmp_path / "port_run", "--total_steps", "3", "--resume_from", converted))
    assert [h["step"] for h in history] == [2] and np.isfinite(history[0]["loss"])
    assert state.step == 3 and state.opt_state["count"] == 3
    assert len(got["batches"]) == len(want["batches"]) == 1
    assert np.array_equal(got["batches"][0], want["batches"][0])
    assert got["indexes"] == want["indexes"] and got["indexes"]

    ema = ocp.StandardCheckpointer().restore(str(jax_ck / "0000002" / "state"))["ema_params"]
    fine, history = driver.main(["--device", "cpu"] + _args(
        corpus, tmp_path / "fine", "--total_steps", "0", "--resume_from", converted,
        "--resume_model_only", "--finetune_from_ema"))
    assert history == [] and fine.step == 0 and fine.opt_state["count"] == 0
    ref = jax_leaves(ema)
    for path, t in paths(fine.params).items():
        if path[0] not in tstep.FROZEN_BUFFERS:  # the sin-cos tables are regenerated
            assert np.array_equal(t.detach().numpy(), ref[path]), path


def test_export_matches_jax(run, tmp_path):
    port = export_from_checkpoint(run["plain"], str(tmp_path / "port"))
    jax_out = jexport(str(run["tmp"] / "jax"), str(tmp_path / "jax"))
    files = sorted(f for f in os.listdir(jax_out) if f.endswith(".safetensors"))
    assert files and files == sorted(f for f in os.listdir(port) if f.endswith(".safetensors"))
    for name in files:
        want, got = load_file(os.path.join(jax_out, name)), load_file(os.path.join(port, name))
        assert sorted(want) == sorted(got), name
        for k in want:
            assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), (name, k)


def test_refusals(run, tmp_path):
    with pytest.raises(FileExistsError, match="already committed"):
        orbax_to_torch.convert(str(run["tmp"] / "jax"), str(run["tmp"] / "port"))

    sgd = jstep.init_train_state(_jax_params(run["cfg"]), optax.sgd(LR, momentum=0.9),
                                 use_ema=False)
    jckpt.save_checkpoint(str(tmp_path / "sgd"), 1, sgd)
    with pytest.raises(ValueError, match=r"exactly one Adam state \{count, mu, nu\}, found 0"):
        orbax_to_torch.convert(str(tmp_path / "sgd"), str(tmp_path / "out"))

    orbax_step = str(run["tmp"] / "jax" / "0000002")
    state, _ = _port_state(run)
    for call in (lambda: tckpt.restore_checkpoint(orbax_step, state),
                 lambda: tckpt.restore_params_only(orbax_step, state.params),
                 lambda: export_from_checkpoint(str(run["tmp"] / "jax"), str(tmp_path / "x"))):
        with pytest.raises(ValueError, match="tools/orbax_to_torch.py --ckpt"):
            call()
