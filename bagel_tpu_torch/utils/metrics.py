"""Throughput accounting: analytic FLOPs model + MFU (port of
bagel_tpu/utils/metrics.py).

Mirrors the reference's qwen2_flop_coefficients / detect_peak_tflops
(pretrain_unified_navit.py:46-95) with the H100's bf16 dense peak in place
of the TPU table, and a `torch.profiler` trace helper.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import time
from typing import Optional

import torch

from bagel_tpu_torch.configs import Qwen2Config

# bf16 dense peak TFLOP/s of one card (NVIDIA's data sheets, SXM parts, at
# their full power limit)
GPU_PEAK_TFLOPS = {"H100": 989.0}


def detect_peak_tflops(device=None) -> float:
    """The bf16 dense peak of `device` (default: CUDA device 0). A card not
    in the table, or no card, raises: an MFU needs a known peak."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: MFU has no peak to divide by")
    name = torch.cuda.get_device_name(device if device is not None else 0)
    for key, tf in GPU_PEAK_TFLOPS.items():
        if key.lower() in name.lower():
            return tf
    raise RuntimeError(f"no bf16 peak known for {name!r}; add it to GPU_PEAK_TFLOPS")


def qwen2_flop_coefficients(cfg: Qwen2Config, mot: bool = True):
    """(flops_per_token, flops_per_seqlen_sq) for one fwd+bwd pass.

    dense: 6 * active params per token; attention: 12 * head_dim * heads *
    layers per seqlen^2 (the reference's coefficients,
    pretrain_unified_navit.py:46-65). mot=True doubles the dense term, for
    a forward that runs both experts over every token (the JAX package's);
    the port runs each token through its own expert, so its trainer counts
    mot=False.
    """
    d, f, L, v = (
        cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers,
        cfg.vocab_size,
    )
    hd = cfg.head_dim
    qd = cfg.num_attention_heads * hd
    kvd = cfg.num_key_value_heads * hd
    per_layer = d * (qd + 2 * kvd) + qd * d + 3 * d * f
    if mot:
        per_layer *= 2
    dense = 6 * (L * per_layer + 2 * v * d)
    attn = 12 * hd * cfg.num_attention_heads * L
    return dense, attn


class ThroughputMeter:
    """Windowed tokens/s + MFU (pretrain_unified_navit.py:737-785). The
    peak is the card's; without a card the MFU is None (a CPU run has no
    device peak)."""

    def __init__(self, cfg: Qwen2Config, n_chips: int = 1, mot: bool = True):
        self.dense_c, self.attn_c = qwen2_flop_coefficients(cfg, mot)
        self.peak = (detect_peak_tflops() * n_chips * 1e12
                     if torch.cuda.is_available() else None)
        self.reset()

    def reset(self):
        self.tokens = 0
        self.seqlen_sq = 0
        self.t0 = time.perf_counter()

    def update(self, num_tokens: int, sample_lens=None):
        self.tokens += num_tokens
        if sample_lens is not None:
            self.seqlen_sq += sum(l * l for l in sample_lens)

    def window(self) -> dict:
        elapsed = max(time.perf_counter() - self.t0, 1e-6)
        flops = self.dense_c * self.tokens + self.attn_c * self.seqlen_sq
        return dict(
            tokens_per_sec=self.tokens / elapsed,
            actual_tflops=flops / elapsed / 1e12,
            mfu=None if self.peak is None else (flops / elapsed) / self.peak,
            elapsed=elapsed,
        )


def make_logger(name: str = "bagel_tpu_torch", log_file: Optional[str] = None,
                rank: int = 0) -> logging.Logger:
    """rank-0 file+stdout logger (train_utils.py:8-26 equivalent)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    if rank == 0:
        fmt = logging.Formatter("[%(asctime)s] %(message)s")
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_file:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        logger.addHandler(logging.NullHandler())
    return logger


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace (CPU and CUDA activity) written to `log_dir` as a
    Chrome trace; a no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))
