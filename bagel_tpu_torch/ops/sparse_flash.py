"""Block-sparse packed attention (port of bagel_tpu/ops/sparse_flash.py).

Attention over one packed sequence under the training predicate

  visible(i, j) = same_doc & (i >= j | same_fan) & !(j is noise of another split)

(`ops.attention.train_packed_mask`). The SigLIP tower uses it with
document_id = fan_id = segment ids and noise_id = -1, which reduces it to
full attention within each image. Rows with no visible key give 0.

`block_liveness` lists, per query block, the key blocks that can hold a
visible key. On a CUDA tensor `sparse_packed_attention` launches the
hand-written Hopper kernel `csrc/sparse_packed_attention.cu` (bf16, head dim
72 or 128; TMA and wgmma) over that table at the kernel's tiles, 128 query
rows by 128 keys (`kernel_tables`, which also flags the tiles whose every
pair is visible), or raises; it takes the plain version
`sparse_packed_attention_plain` only for CPU tensors.

`sparse_packed_attention_train` is the same attention with a gradient (the
JAX package's `custom_vjp`): its forward is the call above, its backward
recomputes the function through the chunked path (`ops.chunked`) one query
chunk of `bwd_chunk` rows at a time, each against the keys of its rows'
documents, and takes that recompute's VJP, so memory stays O(chunk * S).
The ids get no gradient.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from bagel_tpu_torch.ops import _build
from bagel_tpu_torch.ops.attention import dot_attention, train_packed_mask
from bagel_tpu_torch.ops.chunked import chunk_attention, key_ranges

KERNEL = "sparse_packed_attention"
BLOCK_Q = 128  # query rows per tile, compiled into the kernel
BLOCK_K = 128  # keys per tile, compiled into the kernel
HEAD_DIMS = (72, 128)  # the kernel's instantiations
FULL_TILE = 1 << 30  # kernel table flag: every (query, key) pair of the tile is visible
_BIG = 2**30


def block_liveness(
    document_id: torch.Tensor,  # [S] int32 (0 = padding)
    fan_id: torch.Tensor,  # [S] int32 (-1 = none)
    block_q: int,
    block_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact per-q-block tables of the live kv blocks.

    Returns (live_idx [nq, nk] int32, live_cnt [nq] int32): for q block i,
    live_idx[i, :cnt] are the ascending kv block indices that can contain
    visible keys; entries beyond cnt repeat the last live index. Rows with
    no live block point at block 0 with cnt 0. A tile is live iff the
    document ranges of its two blocks intersect and (it touches the causal
    triangle or their fan ranges intersect). S must be a multiple of both
    block sizes."""
    s = document_id.shape[0]
    nq, nk = s // block_q, s // block_k
    dev = document_id.device

    def ranges(ids, blocks, size, none_val):
        b = ids.reshape(blocks, size)
        valid = b != none_val
        lo = torch.where(valid, b, _BIG).amin(dim=1)
        hi = torch.where(valid, b, -_BIG).amax(dim=1)
        return lo, hi, valid.any(dim=1)

    fan = torch.where(fan_id >= 0, fan_id, -1)
    dq_lo, dq_hi, dq_any = ranges(document_id, nq, block_q, 0)
    dk_lo, dk_hi, dk_any = ranges(document_id, nk, block_k, 0)
    fq_lo, fq_hi, fq_any = ranges(fan, nq, block_q, -1)
    fk_lo, fk_hi, fk_any = ranges(fan, nk, block_k, -1)

    doc_possible = (
        (dk_lo[None, :] <= dq_hi[:, None]) & (dk_hi[None, :] >= dq_lo[:, None])
        & dq_any[:, None] & dk_any[None, :]
    )
    # the causal triangle touches the tile iff the last q position >= first k
    q_end = (torch.arange(nq, device=dev) + 1) * block_q - 1
    k_start = torch.arange(nk, device=dev) * block_k
    causal_possible = q_end[:, None] >= k_start[None, :]
    fan_possible = (
        (fk_lo[None, :] <= fq_hi[:, None]) & (fk_hi[None, :] >= fq_lo[:, None])
        & fq_any[:, None] & fk_any[None, :]
    )
    live = doc_possible & (causal_possible | fan_possible)  # [nq, nk]

    cnt = live.sum(dim=1, dtype=torch.int32)
    order = torch.argsort((~live).to(torch.uint8), dim=1, stable=True).to(torch.int32)
    last = order[torch.arange(nq, device=dev), (cnt - 1).clamp(min=0).long()]
    steps = torch.arange(nk, dtype=torch.int32, device=dev)[None, :]
    live_idx = torch.where(steps < cnt[:, None], order, last[:, None])
    return live_idx, cnt


def _pad_ids(document_id, fan_id, noise_id):
    """The ids padded (document 0, fan -1, noise -1) to a multiple of BLOCK_Q."""
    pad = -document_id.shape[0] % BLOCK_Q
    if not pad:
        return document_id, fan_id, noise_id
    return (torch.cat([document_id, document_id.new_zeros(pad)]),
            torch.cat([fan_id, fan_id.new_full((pad,), -1)]),
            torch.cat([noise_id, noise_id.new_full((pad,), -1)]))


def full_tiles(document_id, fan_id, noise_id, block_q: int, block_k: int) -> torch.Tensor:
    """[nq, nk] bool: True where every (query, key) pair of the tile is
    visible: both blocks lie in one document and hold no padding, and the
    tile lies wholly below the diagonal or both blocks lie in one full/noise
    split, and no key is a noise token of another split. A tile that is not
    flagged is masked element by element, so the test may be conservative."""

    def blocks(block):  # per block: its first ids, and whether each id is constant
        d, f, z = (x.reshape(-1, block) for x in (document_id, fan_id, noise_id))
        d0, f0, z0 = d[:, 0], f[:, 0], z[:, 0]
        return (d0, (d == d0[:, None]).all(dim=1) & (d0 != 0),
                f0, (f == f0[:, None]).all(dim=1) & (f0 >= 0),
                z0, (z == z0[:, None]).all(dim=1))

    dq0, dq_one, fq0, fq_one, zq0, zq_one = blocks(block_q)
    dk0, dk_one, fk0, fk_one, zk0, zk_one = blocks(block_k)
    same_doc = dq_one[:, None] & dk_one[None, :] & (dq0[:, None] == dk0[None, :])
    q_first = torch.arange(dq0.shape[0], device=dq0.device) * block_q
    k_last = torch.arange(dk0.shape[0], device=dk0.device) * block_k + block_k - 1
    below = q_first[:, None] >= k_last[None, :]  # first query >= last key
    same_fan = fq_one[:, None] & fk_one[None, :] & (fq0[:, None] == fk0[None, :])
    no_noise = (zk_one & (zk0 < 0))[None, :] | (
        zq_one[:, None] & zk_one[None, :] & (zq0[:, None] == zk0[None, :]))
    return same_doc & (below | same_fan) & no_noise


def kernel_tables(document_id, fan_id, noise_id):
    """The kernel's tables for these ids, any S: (entries [nq, nk] int32,
    counts [nq] int32) — `block_liveness` at the kernel's tiles (BLOCK_Q
    query rows, BLOCK_K keys) on the ids padded (document 0, fan -1, noise
    -1) to a multiple of BLOCK_Q, each entry OR-ed with FULL_TILE where
    `full_tiles` holds. Depends only on the ids: compute it once for all
    the layers that share them."""
    doc, fan, noise = _pad_ids(document_id, fan_id, noise_id)
    live_idx, live_cnt = block_liveness(doc, fan, BLOCK_Q, BLOCK_K)
    full = full_tiles(doc, fan, noise, BLOCK_Q, BLOCK_K).gather(1, live_idx.long())
    return torch.where(full, live_idx | FULL_TILE, live_idx), live_cnt


def sparse_packed_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    document_id: torch.Tensor, fan_id: torch.Tensor, noise_id: torch.Tensor,
    *, scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: `train_packed_mask` +
    `dot_attention` (fp32 products of the working-dtype inputs)."""
    mask = train_packed_mask(document_id, fan_id, noise_id)
    return dot_attention(q[None], k[None], v[None], mask=mask[None], scale=scale)[0]


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.sparse_packed_attention_bf16
    if fn.argtypes is None:  # declare the C signature once
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p] * 9 + [i] * 5 + [i64] * 8 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.sparse_packed_attention_error_string.argtypes = [i]
        lib.sparse_packed_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, ids) -> None:
    dev = q.device
    for name, t in (("k", k), ("v", v)) + tuple(ids.items()):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16; {name} is {t.dtype}")
        if t.ndim != 3 or t.shape[-1] not in HEAD_DIMS:
            raise ValueError(
                f"{name} must be [S, heads, D] with D in {HEAD_DIMS}, got {tuple(t.shape)}"
            )
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:2]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: the kernel's TMA loads need 16-byte rows: a unit last "
                f"stride, other strides multiples of 8 and a 16-byte aligned "
                f"base (strides {t.stride()})"
            )
    s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != s or k.shape[2] != d or h % k.shape[1]:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "do not form GQA attention"
        )
    for name, t in ids.items():
        if t.dtype != torch.int32 or t.shape != (s,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 [{s}] tensor")


def _check_tables(tables, s, dev) -> None:
    entries, counts = tables
    n = -(-s // BLOCK_Q)
    nk = n * BLOCK_Q // BLOCK_K
    for name, t, shape in (("entries", entries, (n, nk)), ("counts", counts, (n,))):
        if (t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"tables: {name} must be a contiguous int32 {shape} tensor on {dev} "
                f"(kernel_tables of the ids), got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


def sparse_packed_attention(
    q: torch.Tensor,  # [S, H, D]
    k: torch.Tensor,  # [S, KH, D]
    v: torch.Tensor,
    document_id: torch.Tensor,  # [S] int32
    fan_id: torch.Tensor,
    noise_id: torch.Tensor,
    *,
    scale: Optional[float] = None,
    tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Exact packed-train-mask attention that skips dead key tiles. Returns
    [S, H, D] in q's dtype. S may be ragged: the kernel masks its own edge.
    `tables`: `kernel_tables` of these very ids, when the caller reuses
    them across calls (built here otherwise). Only their shapes are
    checked: tables of other ids give a wrong output, since a FULL_TILE
    entry skips the per-element mask.

    `sparse_packed_attention.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return sparse_packed_attention_plain(
            q, k, v, document_id, fan_id, noise_id, scale=scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    ids = dict(document_id=document_id, fan_id=fan_id, noise_id=noise_id)
    _check(q, k, v, ids)
    s, h, d = q.shape
    out = torch.empty((s, h, d), dtype=q.dtype, device=q.device)
    if s == 0:
        return out
    scale = d**-0.5 if scale is None else scale
    if not scale > 0:
        raise ValueError(f"the kernel takes a positive scale, got {scale}")
    if tables is None:
        tables = kernel_tables(document_id, fan_id, noise_id)
    _check_tables(tables, s, q.device)
    live_idx, live_cnt = tables
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sparse_packed_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            document_id.data_ptr(), fan_id.data_ptr(), noise_id.data_ptr(),
            live_idx.data_ptr(), live_cnt.data_ptr(),
            s, h, k.shape[1], d, live_idx.shape[1],
            *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], *out.stride()[:2],
            scale, stream,
        )
    if err:
        msg = lib.sparse_packed_attention_error_string(err).decode()
        raise RuntimeError(f"sparse_packed_attention launch failed: {msg} ({err})")
    _build.count_launch(sparse_packed_attention)
    return out


sparse_packed_attention.launches = 0


BWD_CHUNK = 512  # query rows per chunk of the backward's recompute (JAX's bwd_chunk)


class _SparsePackedAttention(torch.autograd.Function):
    """Forward: `sparse_packed_attention` (the kernel on CUDA, its plain
    version on the CPU). Backward: the VJP of the chunked recompute."""

    @staticmethod
    def forward(ctx, q, k, v, document_id, fan_id, noise_id, scale, tables, bwd_chunk):
        ctx.save_for_backward(q, k, v, document_id, fan_id, noise_id)
        ctx.scale, ctx.bwd_chunk = scale, bwd_chunk
        return sparse_packed_attention(q, k, v, document_id, fan_id, noise_id,
                                       scale=scale, tables=tables)

    @staticmethod
    def backward(ctx, g):
        q, k, v, doc, fan, noi = ctx.saved_tensors
        # rows of padding (document 0) take part in no pair: zeroed, so that
        # whatever they hold (stale NaN) cannot reach a product (0 * NaN)
        live = (doc != 0)[:, None, None]
        q, k, v = (torch.where(live, t, 0) for t in (q, k, v))
        s, h, d = q.shape
        kh = k.shape[1]
        chunk = ctx.bwd_chunk
        pos = torch.arange(s, dtype=torch.int32, device=q.device)
        qg = q.reshape(s, kh, h // kh, d)
        g = g.reshape(s, h, d)
        dq = torch.empty_like(q)
        with torch.enable_grad():
            # fp32 leaves: dK and dV sum over the chunks (and a group's query
            # heads) in fp32, cast once at the end
            kf = k.detach().float().requires_grad_()
            vf = v.detach().float().requires_grad_()
            for lo, (k_lo, k_hi) in zip(range(0, s, chunk), key_ranges(doc, chunk)):
                sl, ks = slice(lo, lo + chunk), slice(k_lo, k_hi)
                if k_hi <= k_lo:  # padding rows only: no pair, no gradient
                    dq[sl] = 0
                    continue
                q_blk = qg[sl].detach().requires_grad_()
                out = chunk_attention(q_blk, kf[ks], vf[ks], doc[sl], fan[sl], noi[sl],
                                      pos[sl], doc[ks], fan[ks], noi[ks], ctx.scale, q.dtype,
                                      k_lo)
                torch.autograd.backward(out, g[sl], inputs=[q_blk, kf, vf])
                dq[sl] = q_blk.grad.reshape(-1, h, d)
        dk = kf.grad.to(k.dtype) if kf.grad is not None else torch.zeros_like(k)
        dv = vf.grad.to(v.dtype) if vf.grad is not None else torch.zeros_like(v)
        return dq, dk, dv, None, None, None, None, None, None


def sparse_packed_attention_train(
    q: torch.Tensor,  # [S, H, D]
    k: torch.Tensor,  # [S, KH, D]
    v: torch.Tensor,
    document_id: torch.Tensor,  # [S] int32
    fan_id: torch.Tensor,
    noise_id: torch.Tensor,
    *,
    scale: Optional[float] = None,
    tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    bwd_chunk: int = BWD_CHUNK,
) -> torch.Tensor:
    """`sparse_packed_attention` with a gradient for q, k and v. The forward
    launches the kernel on CUDA tensors (or raises, as the forward-only
    call does) and takes the plain version on CPU tensors; the backward is
    the VJP of `ops.chunked`'s function recomputed in chunks of `bwd_chunk`
    query rows (the last one shorter where `bwd_chunk` does not divide S:
    JAX's scan needs equal chunks and recomputes all S rows at once there,
    the same VJP at O(S^2) memory). `tables` as for
    `sparse_packed_attention`: built once and shared by the layers that use
    the same ids (and by a remat recompute)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _SparsePackedAttention.apply(q, k, v, document_id, fan_id, noise_id,
                                        scale, tables, bwd_chunk)
