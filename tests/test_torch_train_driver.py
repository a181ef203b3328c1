"""bagel_tpu_torch's train driver on the CPU (`--device cpu`, micro
preset, mock tokenizer) over a parquet corpus written here, as
tests/test_driver.py drives bagel_tpu's: steps, periodic and final
checkpoints with data_status, --auto_resume with parameters bit-equal,
model-only resume, an unfinished async save skipped, gradient
accumulation, optimizer/EMA offload, packing workers, and the parallel
flags raising."""

import io
import json
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from bagel_tpu_torch.data.datasets import register_dataset_info
from bagel_tpu_torch.train import driver
from bagel_tpu_torch.train.checkpoint import get_latest_ckpt, step_from_path
from bagel_tpu_torch.train.step import FROZEN_BUFFERS, tree_leaves


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


def test_auto_resume_continues_bit_equal(corpus, tmp_path):
    ckpt = tmp_path / "ckpt"
    first, _ = driver.main(_args(corpus, ckpt, "--total_steps", "2"))
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


def test_model_only_resume(corpus, tmp_path):
    src = tmp_path / "src"
    first, _ = driver.main(_args(corpus, src, "--total_steps", "2"))
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


def test_unfinished_async_save_is_skipped(corpus, tmp_path):
    ckpt = tmp_path / "ckpt"
    driver.main(_args(corpus, ckpt, "--total_steps", "2"))
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


@pytest.mark.parametrize("flag", [["--mesh", "1,2,1"], ["--context_parallel", "fsdp"],
                                  ["--pipeline_parallel", "fsdp"], ["--expert_parallel", "tp"]])
def test_parallel_flags_raise(corpus, tmp_path, flag):
    with pytest.raises(NotImplementedError, match="A8"):
        driver.main(_args(corpus, tmp_path / "p", "--total_steps", "1", *flag))


def test_no_device_raises(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(corpus, tmp_path / "d", "--total_steps", "1")[2:]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.main(args)
