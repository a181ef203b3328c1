"""Flash attention over a cached KV buffer (port of bagel_tpu/ops/flash.py).

A new block of T queries attends over a preallocated KV buffer holding
`past_len` cached tokens plus the new block at [past_len, past_len + valid):

  visible(b, i, j) = j < past + (i+1 if causal else valid)  &  i < valid

Rows i >= valid give 0. GQA maps query head h to KV head h // (H/KH).

On a CUDA tensor `flash_cached_attention` launches the hand-written Hopper
kernel `csrc/flash_cached_attention.cu` (bf16, D=128) or raises; it takes
the plain version `flash_cached_attention_plain` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from bagel_tpu_torch.ops import _build
from bagel_tpu_torch.ops.attention import cache_block_mask, dot_attention

KERNEL = "flash_cached_attention"
HEAD_DIM = 128  # compiled into the kernel


def kv_bucket(n: int) -> int:
    """Cache-buffer capacity for n live tokens, identical to the JAX
    engine's so that cache shapes match: the smallest 256-multiple >= n,
    raised (from 2048 up) until a 256-multiple divisor in [768, 1536]
    exists. The kernel here reads only the live prefix, so the bucket costs
    it nothing."""
    s = -(-n // 256) * 256
    if s < 2048:
        return s
    while max(t for t in range(256, 1537, 256) if s % t == 0) < 768:
        s += 256
    return s


def flash_cached_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    past_len: torch.Tensor, q_valid: torch.Tensor,
    *, causal: bool, scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: `cache_block_mask` +
    `dot_attention` (fp32 products of the working-dtype inputs)."""
    mask = cache_block_mask(k.shape[1], q.shape[1], past_len, q_valid, causal)
    return dot_attention(q, k, v, mask=mask, scale=scale)


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.flash_cached_attention_bf16
    if fn.argtypes is None:  # declare the C signature once
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i] + [i64] * 12 + [
            ctypes.c_float, i, p,
        ]
        fn.restype = ctypes.c_int
        lib.flash_cached_attention_error_string.argtypes = [i]
        lib.flash_cached_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, past_len, q_valid) -> None:
    dev = q.device
    for name, t in (("k", k), ("v", v), ("past_len", past_len), ("q_valid", q_valid)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16; {name} is {t.dtype}")
        if t.ndim != 4 or t.shape[-1] != HEAD_DIM:
            raise ValueError(
                f"{name} must be [B, *, heads, {HEAD_DIM}], got {tuple(t.shape)}"
            )
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: the kernel loads 16-byte rows; needs a unit last "
                f"stride, other strides multiples of 8 and a 16-byte aligned "
                f"base (strides {t.stride()})"
            )
    b, _, h, _ = q.shape
    if k.shape != v.shape or k.shape[0] != b or h % k.shape[2]:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "do not form GQA attention"
        )
    for name, t in (("past_len", past_len), ("q_valid", q_valid)):
        if t.dtype != torch.int32 or t.shape != (b,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 [{b}] tensor")


def flash_cached_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, KH, D] buffer
    v: torch.Tensor,
    past_len: torch.Tensor,  # [B] int32
    q_valid: torch.Tensor,  # [B] int32
    *,
    causal: bool,
    scale: Optional[float] = None,
    int8_compute: bool = False,
) -> torch.Tensor:
    """Attention of the new block over (cache ++ block). Returns [B, T, H, D]
    in q's dtype. T may be ragged: the kernel masks its own edge.

    `flash_cached_attention.launches` counts kernel launches."""
    if int8_compute:
        raise NotImplementedError(
            "int8 attention (the w8a8 kernel) comes with the quantization slice"
        )
    if q.device.type == "cpu":
        return flash_cached_attention_plain(
            q, k, v, past_len, q_valid, causal=causal, scale=scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, past_len, q_valid)
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    if t == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_cached_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            past_len.data_ptr(), q_valid.data_ptr(),
            b, t, s, h, kh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            d**-0.5 if scale is None else scale, int(causal), stream,
        )
    if err:
        msg = lib.flash_cached_attention_error_string(err).decode()
        raise RuntimeError(f"flash_cached_attention launch failed: {msg} ({err})")
    flash_cached_attention.launches += 1
    return out


flash_cached_attention.launches = 0
