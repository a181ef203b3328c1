"""bagel_tpu_torch flash_cached_attention vs bagel_tpu's Pallas kernel.

On CPU tensors the port's wrapper takes its plain version; it is held
against the Pallas kernel in interpret mode at 2e-5, with padded rows
exactly 0. The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py, on the card.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bagel_tpu.ops import flash as jflash
from bagel_tpu_torch.ops import _build
from bagel_tpu_torch.ops import flash as tflash
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, b, t, s, h, kh, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kh, d)).astype(np.float32),
            rng.standard_normal((b, s, kh, d)).astype(np.float32))


def _both(q, k, v, past, valid, causal, **jax_kw):
    want = jflash.flash_cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(past),
        jnp.asarray(valid), causal=causal, interpret=True, **jax_kw)
    got = tflash.flash_cached_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(past),
        torch.tensor(valid), causal=causal)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "b,t,s,h,kh,d,past,valid",
    [
        (1, 8, 32, 4, 2, 32, [10], [8]),          # prefill with cache
        (2, 8, 32, 4, 1, 32, [0, 0], [8, 8]),     # no cache (fresh prefill), MQA
        (1, 16, 16, 2, 2, 32, [0], [12]),         # padded queries (valid < t)
        (2, 8, 64, 8, 2, 32, [17, 0], [5, 8]),    # ragged past + padded block
    ],
)
def test_plain_matches_pallas(causal, b, t, s, h, kh, d, past, valid):
    q, k, v = _inputs(0, b, t, s, h, kh, d)
    past = np.asarray(past, np.int32)
    valid = np.asarray(valid, np.int32)
    got, want = _both(q, k, v, past, valid, causal, block_q=8, block_k=16)
    np.testing.assert_allclose(got, want, **TOL)
    for row in range(b):  # padded rows are exactly 0
        assert np.abs(got[row, valid[row]:]).max(initial=0.0) == 0.0


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_ragged_block(causal):
    """T=300 (not a tile multiple); the Pallas wrapper pads it internally."""
    q, k, v = _inputs(2, 1, 300, 512, 2, 2, 32)
    got, want = _both(q, k, v, np.asarray([64], np.int32), np.asarray([300], np.int32),
                      causal, block_q=256, block_k=256)
    assert got.shape == (1, 300, 2, 32)
    np.testing.assert_allclose(got, want, **TOL)


def test_gqa_head_mapping():
    """Each query head group reads its own kv head."""
    rng = np.random.default_rng(1)
    q, k, _ = _inputs(1, 1, 8, 16, 4, 2, 32)
    v = np.concatenate([np.zeros((1, 16, 1, 32), np.float32),
                        rng.standard_normal((1, 16, 1, 32)).astype(np.float32)], axis=2)
    got, want = _both(q, k, v, np.asarray([8], np.int32), np.asarray([8], np.int32),
                      False, block_q=8, block_k=16)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got[:, :, :2]).max() == 0.0
    assert np.abs(got[:, :, 2:]).max() > 0.0


def test_kv_bucket_matches_jax():
    for n in list(range(1, 3000, 37)) + list(range(3000, 40000, 997)) + [4098 + 64, 8192]:
        assert tflash.kv_bucket(n) == jflash.kv_bucket(n), n


def test_int8_compute_is_a_later_slice():
    """int8_compute is ported (tests/test_torch_flash_int8.py): on CPU
    tensors it runs the int8 kernel's plain version and launches nothing."""
    q, k, v = _inputs(6, 1, 4, 8, 2, 2, 32)
    one = torch.ones(1, dtype=torch.int32)
    args = (torch.tensor(q), torch.tensor(k), torch.tensor(v), one, one)
    got = tflash.flash_cached_attention(*args, causal=True, int8_compute=True)
    want = tflash.flash_cached_attention_plain(*args, causal=True, int8_compute=True)
    assert torch.equal(got, want) and got.abs().max() > 0
    assert tflash.flash_cached_attention_q8.launches == 0


def _no_nvcc_env(tmp_path):
    env = dict(os.environ)
    env["PATH"] = str(tmp_path)
    env["CUDA_HOME"] = str(tmp_path / "no-cuda")
    return env


def test_package_imports_without_nvcc(tmp_path):
    code = (
        "import torch\n"
        "import bagel_tpu_torch, bagel_tpu_torch.inference.engine\n"
        "from bagel_tpu_torch.ops import flash\n"
        "q = torch.ones(1, 4, 2, 128); kv = torch.ones(1, 8, 2, 128)\n"
        "n = torch.tensor([4], dtype=torch.int32)\n"
        "out = flash.flash_cached_attention(q, kv, kv, n, n, causal=True)\n"
        "assert out.shape == q.shape and flash.flash_cached_attention.launches == 0\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_no_nvcc_env(tmp_path),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    for key, val in _no_nvcc_env(tmp_path).items():
        monkeypatch.setenv(key, val)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build("flash_cached_attention")
    assert not (tmp_path / "build").exists()


def test_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(_build.KernelBuildError, match="no sm_90a here"):
        _build.build("flash_cached_attention")
    assert list((tmp_path / "build").iterdir()) == []
