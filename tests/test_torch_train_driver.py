"""bagel_tpu_torch's train driver on the CPU (`--device cpu`, micro
preset, mock tokenizer) over a parquet corpus written here, as
tests/test_driver.py drives bagel_tpu's: steps, periodic and final
checkpoints with data_status, --auto_resume with parameters bit-equal,
model-only resume, an unfinished async save skipped, gradient
accumulation, optimizer/EMA offload, packing workers; and under 4 gloo
processes (tests/torch_dist_util.py) the mesh layouts, pipeline, expert and
context parallelism, each run's losses equal to a one-process run's on the
same global batch within 1e-5, and a bit-equal --auto_resume under a mesh."""

import io
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from bagel_tpu_torch.data.datasets import register_dataset_info
from bagel_tpu_torch.train import driver
from bagel_tpu_torch.train.checkpoint import get_latest_ckpt, step_from_path
from bagel_tpu_torch.train.step import FROZEN_BUFFERS, tree_leaves
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq

    root = tmp_path_factory.mktemp("torch_driver_data")
    rng = np.random.default_rng(0)
    (root / "t2i").mkdir()
    rows = []
    for i in range(6):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (48, 40, 3), dtype=np.uint8), "RGB").save(buf, "PNG")
        rows.append({"image": buf.getvalue(), "captions": json.dumps({"cap": f"picture {i}"})})
    pq.write_table(pa.Table.from_pylist(rows), root / "t2i" / "p0.parquet", row_group_size=3)
    register_dataset_info("t2i_pretrain", "toy_t2i", data_dir=str(root / "t2i"))
    # 32 px at stride 4: an 8 x 7 latent grid fits the micro model's 8 x 8 table
    (root / "data.yaml").write_text(yaml.safe_dump({"t2i_pretrain": {
        "dataset_names": ["toy_t2i"], "weight": 1.0, "is_mandatory": True,
        "num_used_data": [1],
        "image_transform_args": {"max_image_size": 32, "min_image_size": 16,
                                 "image_stride": 4, "max_pixels": 32 * 32},
    }}))
    return root


def _args(corpus, ckpt_dir, *extra):
    return ["--device", "cpu", "--preset", "micro", "--mock_tokenizer",
            "--dataset_config", str(corpus / "data.yaml"), "--ckpt_dir", str(ckpt_dir),
            "--save_every", "2", "--log_every", "1", "--expected_num_tokens", "200",
            "--max_num_tokens", "260", "--max_num_tokens_per_sample", "250",
            "--warmup_steps", "1", "--ce_weight", "1.0", *extra]


def _params(state):
    return [t.detach().clone() for t in tree_leaves(state.params)]


@pytest.fixture(scope="module")
def two_steps(corpus, tmp_path_factory):
    """One two-step run (checkpoint at step 2) that the resume tests start
    from: its final state and its checkpoint directory, which each test
    copies before it resumes or alters anything."""
    ckpt = tmp_path_factory.mktemp("two_steps") / "ckpt"
    state, _ = driver.main(_args(corpus, ckpt, "--total_steps", "2"))
    return state, ckpt


def test_driver_runs_and_checkpoints(corpus, tmp_path):
    state, history = driver.main(_args(corpus, tmp_path / "ckpt", "--total_steps", "3"))
    assert [h["step"] for h in history] == [0, 1, 2] and state.step == 3
    assert all(np.isfinite(h["loss"]) and h["tokens"] > 0 for h in history)
    latest = get_latest_ckpt(str(tmp_path / "ckpt"))
    assert latest is not None and step_from_path(latest) == 3
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["0000002", "0000003"]
    with open(os.path.join(latest, "data_status.json")) as f:
        status = json.load(f)
    assert "t2i_pretrain" in status["0"]  # saved layout: {process index: status}
    assert os.path.exists(os.path.join(latest, "config.json"))


def test_auto_resume_continues_bit_equal(corpus, two_steps, tmp_path):
    first, shared = two_steps
    ckpt = shutil.copytree(shared, tmp_path / "ckpt")
    saved = _params(first)
    again, history = driver.main(_args(corpus, ckpt, "--total_steps", "2", "--auto_resume"))
    assert history == [] and again.step == 2 and again.opt_state["count"] == 2
    for a, b in zip(saved, _params(again)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(first.opt_state["mu"]), tree_leaves(again.opt_state["mu"])):
        assert (a is None and b is None) or torch.equal(a, b)
    _, history = driver.main(_args(corpus, ckpt, "--total_steps", "4", "--auto_resume"))
    assert [h["step"] for h in history] == [2, 3]
    assert step_from_path(get_latest_ckpt(str(ckpt))) == 4


def test_model_only_resume(corpus, two_steps, tmp_path):
    first, shared = two_steps
    src = shutil.copytree(shared, tmp_path / "src")
    latest = get_latest_ckpt(str(src))
    with pytest.raises(ValueError, match="fresh directory"):
        driver.main(_args(corpus, src, "--total_steps", "1", "--resume_from", latest,
                          "--resume_model_only"))
    state, history = driver.main(_args(corpus, tmp_path / "new", "--total_steps", "0",
                                       "--resume_from", latest, "--resume_model_only",
                                       "--finetune_from_ema"))
    assert history == [] and state.step == 0 and state.opt_state["count"] == 0
    for name in state.params:  # the sin-cos tables are regenerated, not restored
        if name not in FROZEN_BUFFERS:
            for a, b in zip(tree_leaves(first.ema_params[name]), tree_leaves(state.params[name])):
                assert torch.equal(a, b), name


def test_unfinished_async_save_is_skipped(corpus, two_steps, tmp_path):
    ckpt = shutil.copytree(two_steps[1], tmp_path / "ckpt")
    (ckpt / "0000009" / "state.tmp-1").mkdir(parents=True)  # a save cut mid-write
    assert step_from_path(get_latest_ckpt(str(ckpt))) == 2
    _, history = driver.main(_args(corpus, ckpt, "--total_steps", "3", "--auto_resume"))
    assert [h["step"] for h in history] == [2]


def test_gradient_accumulation_and_offload(corpus, tmp_path):
    a, ha = driver.main(_args(corpus, tmp_path / "a", "--total_steps", "2",
                              "--gradient_accumulation_steps", "2"))
    assert a.step == 2 and len(ha) == 2
    b, _ = driver.main(_args(corpus, tmp_path / "b", "--total_steps", "2",
                             "--gradient_accumulation_steps", "2", "--optimizer_offload",
                             "--ema_offload"))
    for x, y in zip(_params(a), _params(b)):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(a.ema_params), tree_leaves(b.ema_params)):
        assert torch.equal(x, y)


def test_profile_dir_writes_a_trace(corpus, tmp_path):
    driver.main(_args(corpus, tmp_path / "ck", "--total_steps", "3",
                      "--profile_dir", str(tmp_path / "prof")))
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert os.path.getsize(tmp_path / "prof" / traces[0]) > 0


def test_packing_workers(corpus, tmp_path):
    state, history = driver.main(_args(corpus, tmp_path / "mp", "--total_steps", "2",
                                       "--num_workers", "2"))
    assert len(history) == 2 and all(np.isfinite(h["loss"]) for h in history)


def test_no_device_raises(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(corpus, tmp_path / "d", "--total_steps", "1")[2:]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.main(args)


# -- parallel runs: 4 gloo processes against one process on the same rows --

MICRO_TP = {"num_attention_heads": 4, "num_key_value_heads": 2}  # tp = 2 splits whole heads
# one process on two rows a step: the pipeline at one stage (its math at
# one stage is the plain path's: tests/test_torch_pipeline.py, chip_smoke.py
# phase 11a)
TWO_ROWS = ["--mesh", "1,1,1", "--pipeline_parallel", "fsdp", "--pp_microbatches", "2"]
PARALLEL = {  # flags under the mesh, the one-process run's flags
    "mesh 2,2,1": (["--mesh", "2,2,1"], TWO_ROWS),
    "mesh 1,2,2": (["--mesh", "1,2,2"], []),
    "pp fsdp": (["--mesh", "1,4,1", "--pipeline_parallel", "fsdp", "--pp_microbatches", "2",
                 "--num_hidden_layers", "4"], TWO_ROWS),
    "ep tp": (["--mesh", "1,2,2", "--expert_parallel", "tp"], []),
    "cp fsdp": (["--mesh", "1,4,1", "--context_parallel", "fsdp"], []),
}


def _tp_config(tmp_path):
    path = tmp_path / "llm.json"
    path.write_text(json.dumps(MICRO_TP))
    return ["--llm_config", str(path)]


@pytest.fixture(scope="module")
def one_process(corpus, tmp_path_factory):
    """The one-process run of each set of flags, made once: three of the
    layouts are held to the same run."""
    runs = {}

    def history(*flags):
        if flags not in runs:
            tmp = tmp_path_factory.mktemp("one")
            runs[flags] = driver.main(_args(corpus, tmp / "one", *_tp_config(tmp),
                                            "--total_steps", "3", *flags))[1]
        return runs[flags]

    return history


@pytest.mark.parametrize("name", list(PARALLEL))
def test_parallel_runs_match_one_process(corpus, one_process, tmp_path, name):
    from torch_dist_util import run

    flags, one = PARALLEL[name]
    extra = _tp_config(tmp_path) + ["--total_steps", "3"]
    layers = []
    if "--num_hidden_layers" in flags:
        layers = flags[flags.index("--num_hidden_layers"):][:2]
    extra += layers
    want = one_process(*layers, *one)
    got = run("driver_run", 4, tmp_path,
              argv=_args(corpus, tmp_path / "mesh", *extra, *flags),
              dataset=("t2i_pretrain", "toy_t2i", str(corpus / "t2i")))
    for r in got:  # every process reports the global loss
        assert [h["loss"] for h in r["history"]] == [h["loss"] for h in got[0]["history"]]
    losses = [h["loss"] for h in got[0]["history"]]
    assert all(np.isfinite(losses)) and len(losses) == 3
    for a, b in zip(losses, [h["loss"] for h in want]):
        assert abs(a - b) <= 1e-5 * abs(b), (name, losses, [h["loss"] for h in want])


def test_auto_resume_under_a_mesh_is_bit_equal(corpus, tmp_path):
    from torch_dist_util import run

    got = run("driver_resume", 4, tmp_path,
              argv=_args(corpus, tmp_path / "ck", *_tp_config(tmp_path), "--mesh", "2,1,2"),
              dataset=("t2i_pretrain", "toy_t2i", str(corpus / "t2i")))
    for r in got:
        assert r["resumed_history"] == [] and r["bit_equal"] and r["step"] == 2
        assert r["continued"] == [2]
    assert sorted(os.listdir(tmp_path / "ck")) == ["0000002", "0000003"]
    with open(tmp_path / "ck" / "0000003" / "data_status.json") as f:
        assert sorted(json.load(f)) == ["0", "1", "2", "3"]  # every rank's stream


def test_mesh_needs_its_processes(corpus, tmp_path):
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        driver.main(_args(corpus, tmp_path / "m", "--total_steps", "1", "--mesh", "2,2,1"))
    with pytest.raises(ValueError, match="exclusive"):
        driver.main(_args(corpus, tmp_path / "m", "--total_steps", "1", "--context_parallel",
                          "fsdp", "--expert_parallel", "fsdp"))
    with pytest.raises(ValueError, match="sparse_block"):
        driver.main(_args(corpus, tmp_path / "m", "--total_steps", "1", "--expert_parallel",
                          "fsdp", "--sparse_block", "64"))
