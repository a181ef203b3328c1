"""bagel_tpu_torch stands alone: it imports neither JAX nor bagel_tpu, and
its entry points never quietly fall back to the CPU."""

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
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'bagel_tpu' or m.startswith('bagel_tpu.')]\n"
        "assert not bad, bad\n"
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
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


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
