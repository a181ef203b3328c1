"""bagel_tpu_torch stands alone: it imports neither JAX nor bagel_tpu, nor
Orbax, tensorstore or the repository's tools (the Orbax converter), nor,
on import, PIL; and its entry points never quietly fall back to the
CPU."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bagel_tpu_torch.configs import tiny_bagel
from bagel_tpu_torch.data.tokenizer import MockTokenizer
from bagel_tpu_torch.inference.engine import BagelEngine
from bagel_tpu_torch.models.bagel import init_bagel_params
from bagel_tpu_torch.models.qwen2 import kv_cache_init

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "bagel_tpu_torch"


def test_import_pulls_in_no_jax():
    code = (
        "import sys, pkgutil, importlib, bagel_tpu_torch\n"
        "for m in pkgutil.walk_packages(bagel_tpu_torch.__path__, 'bagel_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'bagel_tpu', 'orbax', 'tensorstore', 'tools', 'orbax_to_torch')]\n"
        "assert not bad, bad\n"
        "new = {'bagel_tpu_torch.utils.quant', 'bagel_tpu_torch.ops.int8_matmul',\n"
        "       'bagel_tpu_torch.ops.int4_matmul', 'bagel_tpu_torch.ops.flash',\n"
        "       'bagel_tpu_torch.inference.taylorseer', 'bagel_tpu_torch.data.transforms',\n"
        "       'bagel_tpu_torch.inference.speculative', 'bagel_tpu_torch.serving.runtime',\n"
        "       'bagel_tpu_torch.serving.server', 'bagel_tpu_torch.serving.app',\n"
        "       'bagel_tpu_torch.data.bpe', 'bagel_tpu_torch.data.tokenizer',\n"
        "       'bagel_tpu_torch.utils.convert', 'bagel_tpu_torch.utils.export_hf',\n"
        "       'bagel_tpu_torch.utils.cuda_graph', 'bagel_tpu_torch.ops.chunked',\n"
        "       'bagel_tpu_torch.train.step', 'bagel_tpu_torch.train.checkpoint',\n"
        "       'bagel_tpu_torch.train.driver', 'bagel_tpu_torch.data.packing',\n"
        "       'bagel_tpu_torch.data.datasets', 'bagel_tpu_torch.data.loader',\n"
        "       'bagel_tpu_torch.data.filesystem', 'bagel_tpu_torch.native',\n"
        "       'bagel_tpu_torch.native.imagepool', 'bagel_tpu_torch.utils.metrics',\n"
        "       'bagel_tpu_torch.inference.decode_program', 'bagel_tpu_torch.data.video',\n"
        "       'bagel_tpu_torch.data.make_parquet_info', 'bagel_tpu_torch.eval.vlm_runner',\n"
        "       'bagel_tpu_torch.eval.gen_runner', 'bagel_tpu_torch.eval.gen_scorer',\n"
        "       'bagel_tpu_torch.eval.judge_scorer', 'bagel_tpu_torch.eval.http_judge',\n"
        "       'bagel_tpu_torch.eval.detectors', 'bagel_tpu_torch.eval.data_prep',\n"
        "       'bagel_tpu_torch.eval.prompts', 'bagel_tpu_torch.eval.scorers.judge',\n"
        "       'bagel_tpu_torch.parallel', 'bagel_tpu_torch.parallel.mesh',\n"
        "       'bagel_tpu_torch.parallel.pipeline', 'bagel_tpu_torch.parallel.expert',\n"
        "       'bagel_tpu_torch.ops.ring', 'bagel_tpu_torch.serving.multihost'}\n"
        "assert new <= set(sys.modules), new - set(sys.modules)\n"
        "# PIL is imported only where an image is resized, decoded or encoded,\n"
        "# regex only where a BPE tokenizer is built, safetensors only where a\n"
        "# checkpoint is read or written, pyarrow where a parquet file is\n"
        "# opened, yaml where the trainer reads its dataset config\n"
        "for lazy in ('PIL', 'regex', 'safetensors', 'gradio', 'pyarrow', 'yaml'):\n"
        "    assert lazy not in sys.modules, f'a module imports {lazy}'\n"
        "print('modules ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "modules ok" in proc.stdout


def test_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|bagel_tpu)(\.|\s|$)", re.M)
    files = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    assert PACKAGE / "utils" / "quant.py" in files and PACKAGE / "ops" / "int4_matmul.py" in files
    assert PACKAGE / "inference" / "taylorseer.py" in files
    assert PACKAGE / "data" / "transforms.py" in files
    for new in ("serving/runtime.py", "serving/server.py", "serving/app.py", "data/bpe.py",
                "utils/convert.py", "utils/export_hf.py", "inference/speculative.py",
                "utils/cuda_graph.py", "ops/chunked.py", "train/step.py",
                "train/checkpoint.py", "train/driver.py", "data/packing.py",
                "data/datasets.py", "data/loader.py", "data/filesystem.py",
                "native/__init__.py", "native/imagepool.py", "native/_build.py",
                "utils/metrics.py", "inference/decode_program.py", "data/video.py",
                "data/make_parquet_info.py"):
        assert PACKAGE / new in files, new
    # every module of the JAX package's eval/, scorers included
    jax_eval = sorted(p.relative_to(REPO / "bagel_tpu") for p in (REPO / "bagel_tpu" / "eval")
                      .rglob("*.py"))
    assert len(jax_eval) >= 22
    for rel in jax_eval:
        assert PACKAGE / rel in files, rel
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_prompt_files_match_jax():
    """The judge prompts are copies: the same files, and every prompt text
    byte for byte (the README names its own package)."""
    jdir, tdir = REPO / "bagel_tpu" / "eval" / "prompts", PACKAGE / "eval" / "prompts"

    def listing(d):
        return sorted(str(p.relative_to(d)) for p in d.rglob("*")
                      if p.is_file() and "__pycache__" not in p.parts)

    assert listing(tdir) == listing(jdir)
    texts = [p for p in listing(jdir) if p.endswith(".txt")]
    assert len(texts) == 32
    for rel in texts:
        assert (tdir / rel).read_bytes() == (jdir / rel).read_bytes(), rel
    from bagel_tpu_torch.eval import prompts

    assert prompts.load("wise", "system") == (jdir / "wise" / "system.txt").read_text()


def test_entry_points_without_device_raise(monkeypatch):
    """With no device and no GPU, entry points raise instead of running on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_bagel(visual_und=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_bagel_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kv_cache_init(cfg.llm, 1, 32)
    params = init_bagel_params(torch.Generator(), cfg, torch.float32, device="cpu")
    tok = MockTokenizer(cfg.llm.vocab_size)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BagelEngine(params, cfg, tok, tok.new_token_ids)
    assert BagelEngine(params, cfg, tok, tok.new_token_ids, device="cpu").device.type == "cpu"
    # the eval command lines: no --device and no GPU raise before any work
    from bagel_tpu_torch.eval import gen_runner, vlm_runner

    with pytest.raises(RuntimeError, match="device='cpu'"):
        gen_runner.main(["--metadata", "absent.jsonl", "--outdir", "absent"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vlm_runner.main(["--data", "absent.jsonl", "--out", "absent.jsonl"])
