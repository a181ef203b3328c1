"""Flash attention over a cached KV buffer (port of bagel_tpu/ops/flash.py).

A new block of T queries attends over a preallocated KV buffer holding
`past_len` cached tokens plus the new block at [past_len, past_len + valid):

  visible(b, i, j) = j < past + (i+1 if causal else valid)  &  i < valid

Rows i >= valid give 0. GQA maps query head h to KV head h // (H/KH).

On a CUDA tensor `flash_cached_attention` launches the hand-written Hopper
kernel `csrc/flash_cached_attention.cu` (bf16, D=128) or raises; it takes
the plain version `flash_cached_attention_plain` only for CPU tensors. A
block of T > 1 queries runs the TMA + wgmma kernel (128-row query tiles,
128-key tiles); a decode step (T == 1) takes the source's split-KV pair
instead: the GQA group packed into one query tile, the live keys split
across `decode_splits` blocks, then a combine (`flash_decode_split_plain`
is its arithmetic in plain PyTorch, a test reference).

With `int8_compute` (the w8a8 attention; by default the JAX package's
switch `BAGEL_FLASH_INT8`, read at each call) q/k/v are quantized to int8
with per-(batch, head) scales by `q8_prep` (on CUDA one hand-written pass of
two kernels in `csrc/flash_cached_attention_q8.cu`, with no host read; its
plain version `q8_prep_plain`) and both products run in int8: on CUDA
through the same source's integer-wgmma kernel (`flash_cached_attention_q8`),
on the CPU through its plain version `flash_q8_plain`. The prep writes V
transposed with its keys permuted within each 32-key group (`q8_v_order`),
the layout the kernel's PV product reads.

`flash_decode_kv8` is the decode step (T = 1) over an int8 KV cache (codes
[B, S, KH, D] and f32 scales [B, S, KH] per key and KV head, as
`models.qwen2` stores them): on CUDA the same split-KV pair (B1-kv8), whose
split kernel stages the codes and scales with cp.async in a ring of two
half tiles a warp and dequantizes each landed half tile into shared memory
while the next one's copies fly, at its own split count (`kv8_splits`); on the
CPU its plain version `flash_decode_kv8_plain` (`kv_dequantize`, then the
plain attention).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from bagel_tpu_torch.ops import _build
from bagel_tpu_torch.ops.attention import cache_block_mask, dot_attention

KERNEL = "flash_cached_attention"
KERNEL_Q8 = "flash_cached_attention_q8"
HEAD_DIM = 128  # compiled into the kernels
Q8_BLOCK_K = 128  # the int8 kernel's key tile: its result depends on it
Q8_KEY_GROUP = 32  # the int8 kernel's V^T keys are permuted within groups of 32
DECODE_BLOCK_K = 64  # the decode kernel's key tile: a split takes whole tiles
DECODE_MAX_GROUP = 16  # query heads per KV head the decode tile holds (m16)
DECODE_MAX_SPLITS = 256  # the combine kernel's table of split weights
NEG_INF = -1e30  # the masked score of the JAX kernels


def default_int8() -> bool:
    """`BAGEL_FLASH_INT8=1` turns the int8 attention on wherever the caller
    does not choose (the JAX package's switch, read here at call time)."""
    return bool(int(os.environ.get("BAGEL_FLASH_INT8", "0")))


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
    *, causal: bool, scale: Optional[float] = None, int8_compute: bool = False,
    block_k: int = Q8_BLOCK_K,
) -> torch.Tensor:
    """The kernels' function in plain PyTorch: `cache_block_mask` +
    `dot_attention` (fp32 products of the working-dtype inputs); with
    int8_compute, `q8_prep_plain` + `flash_q8_plain` at key tile `block_k`."""
    if int8_compute:
        q8, k8, v8, qs, ks, vs = q8_prep_plain(q, k, v, past_len, q_valid)
        return flash_q8_plain(q8, k8, v8, qs, ks, vs, past_len, q_valid, causal=causal,
                              scale=scale, block_k=block_k, out_dtype=q.dtype)
    mask = cache_block_mask(k.shape[1], q.shape[1], past_len, q_valid, causal)
    return dot_attention(q, k, v, mask=mask, scale=scale)


def decode_partials_plain(q, k, v, past_len, q_valid, splits: int,
                          scale: Optional[float] = None):
    """Each split's softmax state for a decode step (T = 1), as the decode
    kernel makes it: the row's live keys are j < lim (lim = past + 1 for a
    valid row, else 0), in n = ceil(lim / 64) tiles, and split s takes the
    tiles [s n / splits, (s+1) n / splits). Returns (m, l, acc): m
    [B, H, splits] the split's max visible score (-inf if none), l its sum of
    f32 exp(score - m), acc [B, H, splits, D] those exps rounded to v's dtype
    times V, in f32."""
    b, t, h, d = q.shape
    assert t == 1, "a decode step has one query row"
    s_len, kh = k.shape[1], k.shape[2]
    g = h // kh
    if scale is None:
        scale = d**-0.5
    dev = q.device
    lim = torch.where(q_valid.to(dev) > 0,
                      torch.clamp(past_len.to(dev, torch.int64) + 1, max=s_len), 0)
    n = (lim + DECODE_BLOCK_K - 1) // DECODE_BLOCK_K  # [B]
    split = torch.arange(splits, device=dev)
    lo = (split[None] * n[:, None]) // splits  # [B, splits] first tile
    hi = ((split[None] + 1) * n[:, None]) // splits
    j = torch.arange(s_len, device=dev)
    tile = (j // DECODE_BLOCK_K)[None, None]
    member = (tile >= lo[..., None]) & (tile < hi[..., None]) & (j < lim[:, None, None])
    kf = k.float().repeat_interleave(g, dim=2)  # [B, S, H, D]
    vf = v.float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q[:, 0].float(), kf) * scale
    sc = scores[:, :, None].masked_fill(~member[:, None], float("-inf"))  # [B, H, splits, S]
    m = sc.amax(dim=-1)
    p = torch.exp(sc - torch.where(torch.isinf(m), 0.0, m)[..., None])  # 0 where masked
    acc = torch.einsum("bhcs,bshd->bhcd", p.to(v.dtype).float(), vf)
    return m, p.sum(dim=-1), acc


def decode_combine_plain(m, l, acc, out_dtype=torch.bfloat16):
    """The splits' states (`decode_partials_plain`) added as the combine
    kernel adds them: weights exp(m_s - max m), splits with m = -inf left
    out; a row with no visible key gives 0. Returns [B, 1, H, D]."""
    top = m.amax(dim=-1, keepdim=True)
    w = torch.where(torch.isinf(m), 0.0, torch.exp(m - torch.where(torch.isinf(top), 0.0, top)))
    total = (w * l).sum(dim=-1)[..., None]
    out = (w[..., None] * acc).sum(dim=-2)
    out = torch.where(total > 0, out / torch.where(total > 0, total, 1.0), 0.0)
    return out[:, None].to(out_dtype)


def kv_dequantize(codes: torch.Tensor, scales: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """int8 KV codes [..., D] times their f32 scales [...], rounded to
    `dtype` (bagel_tpu/models/qwen2.py `_kv_dequantize`)."""
    return (codes.float() * scales[..., None]).to(dtype)


def kv8_live(k8, v8, k_scale, v_scale, past_len, q_valid, dtype=torch.bfloat16):
    """The dequantized K/V a decode step reads: `kv_dequantize` of the keys
    j < past + 1 of each valid row, 0 past them (whatever their codes and
    scales hold there: a NaN scale gives 0)."""
    lim = torch.where(q_valid > 0, past_len.to(torch.int64) + 1, 0)
    alive = (torch.arange(k8.shape[1], device=k8.device)[None, :] < lim[:, None])[..., None, None]
    zero = torch.zeros((), dtype=dtype, device=k8.device)
    return (torch.where(alive, kv_dequantize(k8, k_scale, dtype), zero),
            torch.where(alive, kv_dequantize(v8, v_scale, dtype), zero))


def flash_decode_kv8_plain(q, k8, v8, k_scale, v_scale, past_len, q_valid, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """`flash_decode_kv8`'s function in plain PyTorch: `kv8_live`, then the
    plain attention (`flash_cached_attention_plain`, as for B1's own decode
    step; `flash_decode_split_plain` on the `kv8_live` view is the split
    pair's arithmetic). [B, 1, H, D] in q's dtype."""
    k, v = kv8_live(k8, v8, k_scale, v_scale, past_len, q_valid)
    return flash_cached_attention_plain(q, k, v, past_len, q_valid, causal=True, scale=scale)


def flash_decode_split_plain(q, k, v, past_len, q_valid, *, splits: int,
                             scale: Optional[float] = None) -> torch.Tensor:
    """The decode kernel pair's split + combine arithmetic in plain PyTorch,
    with the number of splits a parameter (a test reference: the main path's
    plain version stays `flash_cached_attention_plain`). [B, 1, H, D] in
    q's dtype."""
    m, l, acc = decode_partials_plain(q, k, v, past_len, q_valid, splits, scale)
    return decode_combine_plain(m, l, acc, q.dtype)


_sm_counts: dict = {}


def _device_index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def _sms(device) -> int:
    index = _device_index(device)
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def decode_splits(b: int, kh: int, device) -> int:
    """Blocks of the decode kernel per (batch row, KV head): enough that
    B x KH x splits blocks fill the card's SMs once (33 at B=1, KH=4 on an
    H100's 132), at most DECODE_MAX_SPLITS."""
    return min(DECODE_MAX_SPLITS, max(1, -(-_sms(device) // (b * kh))))


def kv8_splits(b: int, kh: int, device) -> int:
    """B1-kv8's blocks per (batch row, KV head): enough for two waves of one
    block an SM (its 205 KB of shared memory fill an SM): 8 at 8 slots,
    where the 5 of `decode_splits` took 21.4 µs and 8 took 17.5
    (`chip_smoke.kv8_split_sweep`; NVIDIA H100 80GB HBM3, 700 W)."""
    return min(DECODE_MAX_SPLITS, max(1, 2 * _sms(device) // (b * kh)))


def _to_i8(x: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    """[B, N, heads, D] / per-(batch, head) scale [B, heads] -> int8 codes."""
    xf = x.float() / sc[:, None, :, None]
    return torch.clamp(torch.round(xf), -127, 127).to(torch.int8)


def q8_v_order(n: int, device=None) -> torch.Tensor:
    """[n] int64 (n a multiple of Q8_KEY_GROUP): the key that position p of a
    row of the int8 kernel's V^T holds. Within each group of 32 keys,
    position 16 h + 4 t + e holds key 16 h + 2 t + e % 2 + 8 (e // 2): the
    keys that thread t of an accumulator row holds in wgmma's int32 S
    fragment, in the order of the 8-bit A fragment it feeds to PV (so the
    kernel packs P's codes without shuffles; the sum over keys does not
    care about their order)."""
    p = torch.arange(n, device=device)
    return (p & ~15) | ((p & 12) >> 1) | ((p & 2) << 2) | (p & 1)


def q8_v_layout(v8: torch.Tensor) -> torch.Tensor:
    """int8 V [B, S, KH, D] -> the kernel's V^T [B, KH, D, S32] (S32 = S
    rounded up to 32, zeros past S), keys permuted by `q8_v_order`."""
    b, s, kh, d = v8.shape
    s32 = -(-s // Q8_KEY_GROUP) * Q8_KEY_GROUP
    vt = torch.zeros((b, kh, d, s32), dtype=v8.dtype, device=v8.device)
    vt[..., :s] = v8.permute(0, 2, 3, 1)
    return vt[..., q8_v_order(s32, v8.device)].contiguous()


def q8_v_rows(v8t: torch.Tensor, s: int) -> torch.Tensor:
    """The kernel's V^T [B, KH, D, S32] back to V [B, S, KH, D]: the inverse
    of `q8_v_layout`."""
    inverse = torch.argsort(q8_v_order(v8t.shape[-1], v8t.device))
    return v8t[..., inverse][..., :s].permute(0, 3, 1, 2).contiguous()


def q8_prep_plain(q, k, v, past_len, q_valid):
    """`q8_prep` in plain PyTorch (no host read): symmetric int8 codes and
    per-(batch, head) f32 scales of q [B, T, H, D] and of the live keys of
    k/v [B, S, KH, D], as the JAX wrapper makes them: q's absmax covers every
    row of the block (invalid rows too), k's and v's only each row's keys
    [0, past + valid); scale max(absmax, 1e-12) / 127, codes
    round-half-even(x / scale) clamped to +-127, in f32. Returns (q8
    [B, T, H, D], k8 [B, S, KH, D], v8t [B, KH, D, S32] in `q8_v_layout`,
    qs [B, H], ks [B, KH], vs [B, KH]); codes past a row's live keys are 0
    (the pass on the card leaves them unspecified: `q8_prep`)."""
    s = k.shape[1]
    ends = past_len.to(torch.int64) + q_valid.to(torch.int64)
    alive = torch.arange(s, device=k.device)[None, :, None] < ends[:, None, None]  # [B, S, 1]
    qa = q.float().abs().amax(dim=(1, 3))
    ka = torch.where(alive, k.float().abs().amax(dim=-1), 0.0).amax(dim=1)
    va = torch.where(alive, v.float().abs().amax(dim=-1), 0.0).amax(dim=1)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # product with its reciprocal, which is not the IEEE quotient
    qs, ks, vs = (torch.clamp(a, min=1e-12) / torch.full_like(a, 127.0) for a in (qa, ka, va))
    zero = torch.zeros((), dtype=torch.int8, device=k.device)
    k8 = torch.where(alive[..., None], _to_i8(k, ks), zero)
    v8 = torch.where(alive[..., None], _to_i8(v, vs), zero)
    return _to_i8(q, qs), k8, q8_v_layout(v8), qs, ks, vs


def q8_live(k8, v8t, past_len, q_valid):
    """Copies of k8 and v8t (`q8_prep`'s layouts) with every code past each
    row's live keys [0, past + valid) set to 0: what the plain version
    writes there, where the pass leaves codes unspecified."""
    s = k8.shape[1]
    ends = (past_len.to(torch.int64) + q_valid.to(torch.int64)).to(k8.device)
    alive = torch.arange(s, device=k8.device)[None, :] < ends[:, None]  # [B, S]
    order = q8_v_order(v8t.shape[-1], v8t.device)
    alive_t = order[None, :] < ends[:, None]  # [B, S32]: the key at each V^T position
    zero = torch.zeros((), dtype=k8.dtype, device=k8.device)
    return (torch.where(alive[:, :, None, None], k8, zero),
            torch.where(alive_t[:, None, None, :], v8t, zero))


def q8_prep(q, k, v, past_len, q_valid):
    """The int8 attention's inputs (see `q8_prep_plain`, its function): on a
    CUDA tensor one hand-written pass (two kernels, no host read, so a call
    can be captured in a CUDA graph), on a CPU tensor the plain version.
    The pass leaves the codes past a row's live keys unspecified (0 up to
    the end of the 64-key chunk that holds the live end, unwritten beyond):
    nothing reads them unmasked; `q8_live` zeroes them for a comparison.

    `q8_prep.launches` counts calls that launch the pass."""
    if q.device.type == "cpu":
        return q8_prep_plain(q, k, v, past_len, q_valid)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, past_len, q_valid)
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    s32 = -(-s // Q8_KEY_GROUP) * Q8_KEY_GROUP
    dev = q.device
    q8 = torch.empty((b, t, h, d), dtype=torch.int8, device=dev)
    k8 = torch.empty((b, s, kh, d), dtype=torch.int8, device=dev)
    v8t = torch.empty((b, kh, d, s32), dtype=torch.int8, device=dev)
    qs = torch.empty((b, h), dtype=torch.float32, device=dev)
    ks = torch.empty((b, kh), dtype=torch.float32, device=dev)
    vs = torch.empty((b, kh), dtype=torch.float32, device=dev)
    lib = _library_q8()
    scratch = torch.empty(lib.flash_q8_prep_scratch(b, t, s, h, kh) // 4, dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        err = lib.flash_q8_prep(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q8.data_ptr(), k8.data_ptr(),
            v8t.data_ptr(), qs.data_ptr(), ks.data_ptr(), vs.data_ptr(), scratch.data_ptr(),
            past_len.data_ptr(), q_valid.data_ptr(), b, t, s, h, kh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        msg = lib.flash_cached_attention_q8_error_string(err).decode()
        raise RuntimeError(f"q8_prep launch failed: {msg} ({err})")
    _build.count_launch(q8_prep)
    return q8, k8, v8t, qs, ks, vs


q8_prep.launches = 0


def flash_q8_plain(
    q8, k8, v8t, qs, ks, vs, past_len, q_valid, *, causal: bool,
    scale: Optional[float] = None, block_k: int = Q8_BLOCK_K, out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """The int8 kernel's function in plain PyTorch on `q8_prep`'s codes and
    scales (V^T in `q8_v_layout`), key tile by key tile as
    `_flash_kernel_q8` runs it (the row max of P, and so the codes, are per
    tile)."""
    return _flash_q8_rows(q8, k8, q8_v_rows(v8t, k8.shape[1]), qs, ks, vs, past_len, q_valid,
                          causal=causal, scale=scale, block_k=block_k, out_dtype=out_dtype)


def _flash_q8_rows(q8, k8, v8, qs, ks, vs, past_len, q_valid, *, causal, scale, block_k,
                   out_dtype):
    """`flash_q8_plain` with V as [B, S, KH, D]. Both products are float32
    matmuls of the int8 codes, which are exact: |q8 . k8| <= 127^2 D and
    |codes . v8| <= 127^2 block_k, both under 2^24. Tiles past every row's
    live keys change nothing and are not run (a host read of the bound)."""
    assert block_k * 127 * 127 < 2**24 and q8.shape[-1] * 127 * 127 < 2**24
    b, t, h, d = q8.shape
    kh = k8.shape[2]
    s_live = min(k8.shape[1], int((past_len.to(torch.int64) + q_valid.to(torch.int64)).max()))
    g = h // kh
    if scale is None:
        scale = d**-0.5
    qf = q8.float().transpose(1, 2)  # [B, H, T, D]
    kf = k8.float().transpose(1, 2).repeat_interleave(g, dim=1)  # [B, H, S, D]
    vf = v8.float().transpose(1, 2).repeat_interleave(g, dim=1)
    ksh, vsh = ks.repeat_interleave(g, dim=1), vs.repeat_interleave(g, dim=1)
    c = (qs * ksh * scale)[:, :, None, None]
    vs127 = (vsh / 127.0)[:, :, None, None]
    rows = torch.arange(t, device=q8.device)[None, None, :, None]
    past = past_len.to(torch.int64)[:, None, None, None]
    valid = q_valid.to(torch.int64)[:, None, None, None]
    lim = past + (rows + 1 if causal else valid)
    m = torch.full((b, h, t, 1), NEG_INF, device=q8.device)
    l = torch.zeros((b, h, t, 1), device=q8.device)
    acc = torch.zeros((b, h, t, d), device=q8.device)
    for k0 in range(0, s_live, block_k):
        k1 = min(k0 + block_k, s_live)
        cols = torch.arange(k0, k1, device=q8.device)[None, None, None, :]
        mask = (cols < lim) & (cols < past + valid) & (rows < valid)
        s = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * c
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        row_m = torch.clamp(p.amax(dim=-1, keepdim=True), min=1e-20)
        codes = torch.round(p * (127.0 / row_m))
        pv = (codes @ vf[:, :, k0:k1]) * (row_m * vs127)
        l = l * alpha + codes.sum(dim=-1, keepdim=True) * (row_m / 127.0)
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-20)).transpose(1, 2).to(out_dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.flash_cached_attention_bf16
    if fn.argtypes is None:  # declare the C signature once
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i] + [i64] * 12 + [
            ctypes.c_float, i, p,
        ]
        fn.restype = ctypes.c_int
        dec = lib.flash_decode_bf16
        dec.argtypes = [p] * 8 + [i] * 5 + [i64] * 10 + [ctypes.c_float, p]
        dec.restype = ctypes.c_int
        kv8 = lib.flash_decode_kv8
        kv8.argtypes = [p] * 10 + [i] * 5 + [i64] * 16 + [ctypes.c_float, p]
        kv8.restype = ctypes.c_int
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
    if q.shape[1] == 1 and h // k.shape[2] > DECODE_MAX_GROUP:
        raise ValueError(f"the decode kernel packs at most {DECODE_MAX_GROUP} query heads "
                         f"per KV head into its tile, got {h // k.shape[2]}")


def _library_q8() -> ctypes.CDLL:
    lib = _build.load(KERNEL_Q8)
    fn = lib.flash_cached_attention_q8
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 5 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        prep = lib.flash_q8_prep
        prep.argtypes = [p] * 12 + [i] * 5 + [ctypes.c_int64] * 9 + [p]
        prep.restype = ctypes.c_int
        lib.flash_q8_prep_scratch.argtypes = [i] * 5
        lib.flash_q8_prep_scratch.restype = ctypes.c_int64
        lib.flash_cached_attention_q8_error_string.argtypes = [i]
        lib.flash_cached_attention_q8_error_string.restype = ctypes.c_char_p
    return lib


def flash_cached_attention_q8(
    q8: torch.Tensor,  # [B, T, H, D] int8
    k8: torch.Tensor,  # [B, S, KH, D] int8
    v8: torch.Tensor,  # [B, KH, D, S32] int8 in `q8_v_layout`
    qs: torch.Tensor,  # [B, H] f32
    ks: torch.Tensor,  # [B, KH] f32
    vs: torch.Tensor,
    past_len: torch.Tensor,
    q_valid: torch.Tensor,
    *,
    causal: bool,
    scale: Optional[float] = None,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """The int8 attention on `q8_prep`'s codes and scales -> [B, T, H, D] in
    out_dtype: the CUDA kernel (key tile Q8_BLOCK_K, bf16 out) on a CUDA
    tensor, the plain version on a CPU tensor. The codes past a row's live
    keys are never read unmasked.

    `flash_cached_attention_q8.launches` counts kernel launches."""
    if q8.device.type == "cpu":
        return flash_q8_plain(q8, k8, v8, qs, ks, vs, past_len, q_valid, causal=causal,
                              scale=scale, out_dtype=out_dtype)
    if q8.device.type != "cuda":
        raise ValueError(f"no kernel for device {q8.device}")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel writes bf16, not {out_dtype}")
    b, t, h, d = q8.shape
    s, kh = k8.shape[1], k8.shape[2]
    s32 = -(-s // Q8_KEY_GROUP) * Q8_KEY_GROUP
    for name, x, shape in (("k8", k8, (b, s, kh, d)), ("v8", v8, (b, kh, d, s32))):
        if x.dtype != torch.int8 or x.shape != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int8 {list(shape)} tensor, "
                             f"got {x.dtype} {tuple(x.shape)}")
    if q8.dtype != torch.int8 or not q8.is_contiguous() or d != HEAD_DIM or h % kh:
        raise ValueError(f"q8 must be a contiguous int8 [B, T, H, {HEAD_DIM}] tensor "
                         f"with H % KH == 0, got {q8.dtype} {tuple(q8.shape)}")
    for name, x, n in (("qs", qs, h), ("ks", ks, kh), ("vs", vs, kh)):
        if x.dtype != torch.float32 or x.shape != (b, n) or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 [{b}, {n}] tensor")
    for name, x in (("past_len", past_len), ("q_valid", q_valid)):
        if x.dtype != torch.int32 or x.shape != (b,) or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 [{b}] tensor")
    for name, x in (("k8", k8), ("v8", v8), ("qs", qs), ("ks", ks), ("vs", vs),
                    ("past_len", past_len), ("q_valid", q_valid)):
        if x.device != q8.device:
            raise ValueError(f"{name} is on {x.device}, q8 on {q8.device}")
    out = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=q8.device)
    if t == 0:
        return out
    lib = _library_q8()
    with torch.cuda.device(q8.device):
        stream = torch.cuda.current_stream(q8.device).cuda_stream
        err = lib.flash_cached_attention_q8(
            q8.data_ptr(), k8.data_ptr(), v8.data_ptr(), out.data_ptr(),
            qs.data_ptr(), ks.data_ptr(), vs.data_ptr(), past_len.data_ptr(),
            q_valid.data_ptr(), b, t, s, h, kh,
            d**-0.5 if scale is None else scale, int(causal), stream,
        )
    if err:
        msg = lib.flash_cached_attention_q8_error_string(err).decode()
        raise RuntimeError(f"flash_cached_attention_q8 launch failed: {msg} ({err})")
    _build.count_launch(flash_cached_attention_q8)
    return out


flash_cached_attention_q8.launches = 0


def _decode(lib, q, k, v, out, past_len, q_valid, scale, stream, splits: int) -> int:
    """Launch the decode pair (T = 1) with `splits` blocks a (row, KV head)
    into `out`; returns the library's error code."""
    b, _, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    # f32 partials of every (row, KV head, split, head of its group)
    part_acc = torch.empty(b * splits * h * d, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(b * splits * h * 2, dtype=torch.float32, device=q.device)
    return lib.flash_decode_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), past_len.data_ptr(), q_valid.data_ptr(),
        b, s, h, kh, splits, q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(2), scale, stream,
    )


def flash_cached_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, KH, D] buffer
    v: torch.Tensor,
    past_len: torch.Tensor,  # [B] int32
    q_valid: torch.Tensor,  # [B] int32
    *,
    causal: bool,
    scale: Optional[float] = None,
    int8_compute: Optional[bool] = None,
) -> torch.Tensor:
    """Attention of the new block over (cache ++ block). Returns [B, T, H, D]
    in q's dtype (bf16 on CUDA). T may be ragged: the kernels
    mask their own edge. int8_compute=None reads `default_int8()`.

    On CUDA a decode step (T == 1) runs the split-KV pair (two kernels, one
    call); a longer block the 128-row TMA + wgmma kernel.

    `flash_cached_attention.launches` counts calls that launch the bf16
    kernels."""
    if int8_compute is None:
        int8_compute = default_int8()
    if int8_compute:
        q8, k8, v8, qs, ks, vs = q8_prep(q, k, v, past_len, q_valid)
        return flash_cached_attention_q8(q8, k8, v8, qs, ks, vs, past_len, q_valid,
                                         causal=causal, scale=scale, out_dtype=q.dtype)
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
    scale = d**-0.5 if scale is None else scale
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if t == 1:  # causal or not: one row sees past + 1 keys
            err = _decode(lib, q, k, v, out, past_len, q_valid, scale, stream,
                          decode_splits(b, kh, q.device))
        else:
            err = lib.flash_cached_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                past_len.data_ptr(), q_valid.data_ptr(),
                b, t, s, h, kh,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                scale, int(causal), stream,
            )
    if err:
        msg = lib.flash_cached_attention_error_string(err).decode()
        raise RuntimeError(f"flash_cached_attention launch failed: {msg} ({err})")
    _build.count_launch(flash_cached_attention)
    return out


flash_cached_attention.launches = 0


def _check_kv8(q, k8, v8, k_scale, v_scale, past_len, q_valid) -> None:
    b, t, h, d = q.shape
    if q.dtype != torch.bfloat16 or t != 1 or d != HEAD_DIM:
        raise ValueError(f"q must be a bf16 [B, 1, H, {HEAD_DIM}] tensor, got {q.dtype} "
                         f"{tuple(q.shape)}")
    if q.stride(-1) != 1 or q.stride(0) % 8 or q.stride(2) % 8 or q.data_ptr() % 16:
        raise ValueError(f"q: the kernel loads 16-byte rows (strides {q.stride()})")
    s, kh = k8.shape[1], k8.shape[2]
    for name, x in (("k8", k8), ("v8", v8)):
        if x.dtype != torch.int8 or x.shape != (b, s, kh, d):
            raise ValueError(f"{name} must be an int8 [{b}, {s}, {kh}, {d}] tensor, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.stride(-1) != 1 or any(st % 16 for st in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel loads 16 codes at a time; needs a unit last "
                             f"stride, other strides multiples of 16 and a 16-byte aligned "
                             f"base (strides {x.stride()})")
    for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
        if x.dtype != torch.float32 or x.shape != (b, s, kh):
            raise ValueError(f"{name} must be an f32 [{b}, {s}, {kh}] tensor, got {x.dtype} "
                             f"{tuple(x.shape)}")
    if h % kh or h // kh > DECODE_MAX_GROUP:
        raise ValueError(f"{h} query heads over {kh} KV heads: the decode kernel packs at most "
                         f"{DECODE_MAX_GROUP} heads of a group into its tile")
    for name, x in (("past_len", past_len), ("q_valid", q_valid)):
        if x.dtype != torch.int32 or x.shape != (b,) or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 [{b}] tensor")
    for name, x in (("k8", k8), ("v8", v8), ("k_scale", k_scale), ("v_scale", v_scale),
                    ("past_len", past_len), ("q_valid", q_valid)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def _decode_kv8(lib, q, k8, v8, k_scale, v_scale, out, past_len, q_valid, scale, stream,
                splits: int) -> int:
    """Launch B1-kv8's pair with `splits` blocks a (row, KV head) into
    `out`; returns the library's error code."""
    b, _, h, d = q.shape
    s, kh = k8.shape[1], k8.shape[2]
    part_acc = torch.empty(b * splits * h * d, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(b * splits * h * 2, dtype=torch.float32, device=q.device)
    return lib.flash_decode_kv8(
        q.data_ptr(), k8.data_ptr(), v8.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), past_len.data_ptr(),
        q_valid.data_ptr(), b, s, h, kh, splits, q.stride(0), q.stride(2),
        *k8.stride()[:3], *v8.stride()[:3], *k_scale.stride(), *v_scale.stride(),
        out.stride(0), out.stride(2), scale, stream,
    )


def flash_decode_kv8(
    q: torch.Tensor,  # [B, 1, H, D] bf16
    k8: torch.Tensor,  # [B, S, KH, D] int8 codes
    v8: torch.Tensor,
    k_scale: torch.Tensor,  # [B, S, KH] f32
    v_scale: torch.Tensor,
    past_len: torch.Tensor,  # [B] int32
    q_valid: torch.Tensor,  # [B] int32
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """A decode step's attention over an int8 KV cache -> [B, 1, H, D]: the
    keys j < past + 1 of each valid row, dequantized as `kv_dequantize`
    does. On a CUDA tensor the split-KV pair with the int8 split kernel
    (`csrc/flash_cached_attention.cu`, B1-kv8), on a CPU tensor
    `flash_decode_kv8_plain`. Codes and scales past each row's live keys
    are never read.

    `flash_decode_kv8.launches` counts calls that launch the pair."""
    if q.device.type == "cpu":
        return flash_decode_kv8_plain(q, k8, v8, k_scale, v_scale, past_len, q_valid,
                                      scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_kv8(q, k8, v8, k_scale, v_scale, past_len, q_valid)
    b, _, h, d = q.shape
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = _decode_kv8(lib, q, k8, v8, k_scale, v_scale, out, past_len, q_valid,
                          d**-0.5 if scale is None else scale,
                          torch.cuda.current_stream(q.device).cuda_stream,
                          kv8_splits(b, k8.shape[2], q.device))
    if err:
        msg = lib.flash_cached_attention_error_string(err).decode()
        raise RuntimeError(f"flash_decode_kv8 launch failed: {msg} ({err})")
    _build.count_launch(flash_decode_kv8)
    return out


flash_decode_kv8.launches = 0
