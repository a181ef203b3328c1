"""`python -m bagel_tpu_torch.utils.export_hf` over the port's own training
checkpoints: a tiny CPU training run saves steps 1 and 2 with EMA, then the
command line exports the latest step's EMA weights (or, with --raw, the raw
parameters) to the release layout, bit for bit, with export_meta.json's
fields as the JAX package writes them (source, weights, and step: the
state's update count); a state saved without EMA exports its
parameters. The expected tensors come from the training run's own state
(and, for step 1, from restore_params_only on a template model), not
from the reader the export uses."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bagel_tpu_torch.configs import bagel_config_from_json
from bagel_tpu_torch.train import driver
from bagel_tpu_torch.train.checkpoint import checkpoint_meta, restore_params_only
from bagel_tpu_torch.utils.convert import export_bagel, load_checkpoint_dir
from bagel_tpu_torch.utils.export_hf import export_from_checkpoint

from test_torch_train_driver import _args, corpus  # noqa: F401
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):  # noqa: F811
    """(checkpoint root, the final TrainState): step directory 2 holds that
    state."""
    root = tmp_path_factory.mktemp("export_ckpt") / "ckpt"
    state, _ = driver.main(_args(corpus, root, "--total_steps", "2", "--save_every", "1"))
    assert sorted(p.name for p in root.iterdir()) == ["0000001", "0000002"]
    return root, state


def _cli(*argv):
    proc = subprocess.run([sys.executable, "-m", "bagel_tpu_torch.utils.export_hf", *argv],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _assert_written(out, tree, cfg, skip=()):
    """The export in `out` holds `tree`'s tensors bit for bit, apart from
    the keys that start with a name in `skip`."""
    from safetensors.torch import load_file

    want = export_bagel(tree, cfg)
    got = load_file(str(out / "model.safetensors"))
    assert sorted(got) == sorted(want) and len(got) > 50
    for k, t in want.items():
        if k.startswith(skip):
            continue
        assert got[k].dtype == t.dtype and torch.equal(got[k], t.cpu()), k
    ema = load_file(str(out / "ema.safetensors"))
    assert all(torch.equal(ema[k], got[k]) for k in got)


@pytest.mark.parametrize("raw", [False, True])
def test_cli_exports_latest_step(trained, tmp_path, raw):
    ckpt, state = trained
    out = tmp_path / "hf"
    assert f"exported to {out}" in _cli("--ckpt", str(ckpt), "--out", str(out),
                                        *(["--raw"] if raw else []))
    step2 = ckpt / "0000002"
    cfg = bagel_config_from_json((step2 / "config.json").read_text())
    meta = json.loads((out / "export_meta.json").read_text())
    assert meta == {"source": str(step2), "weights": "params" if raw else "ema", "step": 2}
    trees = {"params": state.params, "ema": state.ema_params}
    _assert_written(out, trees["params" if raw else "ema"], cfg)
    # EMA and the raw weights differ after a step with lr > 0
    assert not all(torch.equal(a, b) for a, b in zip(
        export_bagel(trees["params"], cfg).values(), export_bagel(trees["ema"], cfg).values()))
    # the exported directory loads as a release checkpoint
    back = load_checkpoint_dir(str(out), cfg)
    assert torch.equal(back["llm"]["embed"],
                       trees["params" if raw else "ema"]["llm"]["embed"].cpu())


def test_export_step_dir_and_no_ema(trained, corpus, tmp_path):  # noqa: F811
    ckpt, state = trained
    step1 = ckpt / "0000001"
    out = export_from_checkpoint(str(step1), str(tmp_path / "s1"))
    meta = json.loads((Path(out) / "export_meta.json").read_text())
    # the step is the state's update count (JAX's rule): the loop saves step
    # directory 1 after its second update
    assert meta == {"source": str(step1), "weights": "ema",
                    "step": checkpoint_meta(str(step1))["step"]} and meta["step"] == 2
    cfg = bagel_config_from_json((step1 / "config.json").read_text())
    # the step-1 EMA tree as restore_params_only fills a template model;
    # it never restores the sin-cos tables (they are regenerated from the
    # config), and their EMA drifts from the template's by rounding
    _, ema1 = restore_params_only(str(step1), state.params)
    _assert_written(Path(out), ema1, cfg, skip=("vit_pos_embed.", "latent_pos_embed."))

    plain = tmp_path / "noema"
    pstate, _ = driver.main(_args(corpus, plain, "--total_steps", "1", "--save_every", "1",
                                  "--ema", "0"))
    out = export_from_checkpoint(str(plain), str(tmp_path / "hf"))
    meta = json.loads((Path(out) / "export_meta.json").read_text())
    assert meta["weights"] == "params" and meta["step"] == 1
    assert "ema" not in checkpoint_meta(str(plain / "0000001"))["trees"]
    _assert_written(Path(out), pstate.params, cfg)
    with pytest.raises(FileNotFoundError):
        export_from_checkpoint(str(tmp_path / "absent"), str(tmp_path / "x"))
