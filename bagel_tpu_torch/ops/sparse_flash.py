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
pair is visible, and lists the transposed table that the gradient walks),
or raises; it takes the plain version `sparse_packed_attention_plain` only
for CPU tensors. With `for_backward` it also returns each row's
logsumexp and the output's rounding residual, which the backward reads.

`sparse_packed_attention_train` is the same attention with a gradient (the
JAX package's `custom_vjp`): its forward is the call above with the
logsumexp kept, its backward `sparse_packed_attention_bwd`: on a CUDA
tensor the hand-written Hopper kernels of
`csrc/sparse_packed_attention_bwd.cu` (a flash backward over the kernel's
tables: dK/dV per key tile, dQ per query tile, deterministic), on a CPU
tensor their plain twin `sparse_packed_attention_bwd_plain`, chunked over
`bwd_chunk` query rows so that memory stays O(chunk * S). JAX's backward
recomputes the function through its chunked path and takes the VJP: the
same gradient. The ids get no gradient.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from bagel_tpu_torch.ops import _build
from bagel_tpu_torch.ops.attention import dot_attention, train_packed_mask
from bagel_tpu_torch.ops.chunked import chunk_mask, key_ranges

KERNEL = "sparse_packed_attention"
BWD_KERNEL = "sparse_packed_attention_bwd"
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
    triangle or their fan ranges intersect) (`_live_tiles`). S must be a
    multiple of both block sizes."""
    return _compact(_live_tiles(document_id, fan_id, block_q, block_k))


def _compact(live: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx [n, m] int32, cnt [n] int32) of a [n, m] bool matrix: row i's
    True columns in ascending order, then its last one repeated (column 0
    with cnt 0 for a row with none)."""
    n, m = live.shape
    dev = live.device
    cnt = live.sum(dim=1, dtype=torch.int32)
    order = torch.argsort((~live).to(torch.uint8), dim=1, stable=True).to(torch.int32)
    last = order[torch.arange(n, device=dev), (cnt - 1).clamp(min=0).long()]
    steps = torch.arange(m, dtype=torch.int32, device=dev)[None, :]
    return torch.where(steps < cnt[:, None], order, last[:, None]), cnt


def _live_tiles(document_id, fan_id, block_q: int, block_k: int) -> torch.Tensor:
    """[nq, nk] bool: the (q block, kv block) tiles that can hold a visible
    pair (`block_liveness`'s matrix before it is compacted)."""
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
    return doc_possible & (causal_possible | fan_possible)  # [nq, nk]


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


class KernelTables(NamedTuple):
    """The kernels' tables of one id set, in both directions (n = the tiles
    of S, padded). Each entry is a tile index OR-ed with FULL_TILE where
    every pair of the tile is visible."""

    entries: torch.Tensor  # [n, n] int32: each query tile's live key tiles (forward, dQ)
    counts: torch.Tensor  # [n] int32
    t_entries: torch.Tensor  # [n, n] int32: each key tile's live query tiles (dK/dV)
    t_counts: torch.Tensor  # [n] int32


def kernel_tables(document_id, fan_id, noise_id) -> KernelTables:
    """The kernels' tables for these ids, any S: `block_liveness` at the
    kernel's tiles (BLOCK_Q query rows, BLOCK_K keys) on the ids padded
    (document 0, fan -1, noise -1) to a multiple of BLOCK_Q, and the same
    live matrix transposed (each key tile's live query tiles, ascending);
    each entry OR-ed with FULL_TILE where `full_tiles` holds. Depends only
    on the ids: compute it once for all the layers that share them."""
    doc, fan, noise = _pad_ids(document_id, fan_id, noise_id)
    live = _live_tiles(doc, fan, BLOCK_Q, BLOCK_K)
    full = full_tiles(doc, fan, noise, BLOCK_Q, BLOCK_K)

    def flagged(live, full):
        idx, cnt = _compact(live)
        return torch.where(full.gather(1, idx.long()), idx | FULL_TILE, idx), cnt

    return KernelTables(*flagged(live, full), *flagged(live.T, full.T))


def sparse_packed_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    document_id: torch.Tensor, fan_id: torch.Tensor, noise_id: torch.Tensor,
    *, scale: Optional[float] = None, for_backward: bool = False,
):
    """The kernel's function in plain PyTorch: `train_packed_mask` +
    `dot_attention` (fp32 products of the working-dtype inputs).
    for_backward: (out, lse, out_lo) as the kernel's call gives them.
    Padding keys (document 0) take part in no pair: their rows are zeroed
    first, as the kernel zeroes them, so that stale NaN there cannot meet a
    zero probability (0 * NaN)."""
    mask = train_packed_mask(document_id, fan_id, noise_id)
    live = (document_id != 0)[:, None, None]
    k, v = (torch.where(live, t, 0) for t in (k, v))
    out = dot_attention(q[None], k[None], v[None], mask=mask[None], scale=scale)[0]
    if not for_backward:
        return out
    s, h, d = q.shape
    kh = k.shape[1]
    scale = d**-0.5 if scale is None else scale
    logits = torch.einsum("qhgd,khd->hgqk", q.float().reshape(s, kh, h // kh, d),
                          k.float()) * scale
    logits.masked_fill_(~mask, -torch.inf)
    lse = torch.logsumexp(logits, dim=-1).reshape(h, s)
    probs = torch.softmax(logits, dim=-1).nan_to_num_(nan=0.0).to(v.dtype).float()
    out32 = torch.einsum("hgqk,khd->qhgd", probs, v.float()).reshape(s, h, d)
    return (out, torch.where(mask.any(dim=1), lse, torch.inf),
            (out32 - out.float()).to(q.dtype))


_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the C signatures: pointers, ints (S, H, KH, D, the table width), strides,
# the scale and the stream
_ARGTYPES = {
    KERNEL: [_P] * 11 + [_I] * 5 + [_I64] * 8 + [ctypes.c_float, _P],
    BWD_KERNEL: [_P] * 18 + [_I] * 5 + [_I64] * 10 + [ctypes.c_float, _P],
}


def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_bf16")
    if fn.argtypes is None:  # declare the C signature once
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
    return lib


def _tma_ok(t: torch.Tensor) -> bool:
    """The kernels' TMA loads need 16-byte rows: a unit last stride, the
    other strides multiples of 8 elements and a 16-byte aligned base."""
    return t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:2]) and not t.data_ptr() % 16


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
        if not _tma_ok(t):
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
    if not isinstance(tables, KernelTables):
        raise TypeError(f"tables must be kernel_tables(...) of the ids, got {type(tables)}")
    n = -(-s // BLOCK_Q)
    nk = n * BLOCK_Q // BLOCK_K
    shapes = dict(entries=(n, nk), counts=(n,), t_entries=(nk, n), t_counts=(nk,))
    for name, t in tables._asdict().items():
        shape = shapes[name]
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
    tables: Optional[KernelTables] = None,
    for_backward: bool = False,
):
    """Exact packed-train-mask attention that skips dead key tiles. Returns
    [S, H, D] in q's dtype; with `for_backward`, (out, lse, out_lo), what
    the backward reads: each row's logsumexp of its visible scaled scores
    ([H, S] fp32, nats, +inf for a row with no visible key) and the
    output's rounding residual ([S, H, D], the fp32 output minus out, in
    q's dtype). `out` is the same bits either way. S may be ragged: the
    kernel masks its own edge. `tables`: `kernel_tables` of these very ids, when the
    caller reuses them across calls (built here otherwise). Only their
    shapes are checked: tables of other ids give a wrong output, since a
    FULL_TILE entry skips the per-element mask.

    `sparse_packed_attention.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return sparse_packed_attention_plain(
            q, k, v, document_id, fan_id, noise_id, scale=scale, for_backward=for_backward
        )
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    ids = dict(document_id=document_id, fan_id=fan_id, noise_id=noise_id)
    _check(q, k, v, ids)
    s, h, d = q.shape
    out = torch.empty((s, h, d), dtype=q.dtype, device=q.device)
    lse = out_lo = None
    if for_backward:
        lse = torch.empty((h, s), dtype=torch.float32, device=q.device)
        out_lo = torch.empty_like(out)
    result = (out, lse, out_lo) if for_backward else out
    if s == 0:
        return result
    scale = d**-0.5 if scale is None else scale
    if not scale > 0:
        raise ValueError(f"the kernel takes a positive scale, got {scale}")
    if tables is None:
        tables = kernel_tables(document_id, fan_id, noise_id)
    _check_tables(tables, s, q.device)
    lib = _library(KERNEL)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sparse_packed_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if out_lo is None else out_lo.data_ptr(),
            document_id.data_ptr(), fan_id.data_ptr(), noise_id.data_ptr(),
            tables.entries.data_ptr(), tables.counts.data_ptr(),
            s, h, k.shape[1], d, tables.entries.shape[1],
            *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], *out.stride()[:2],
            scale, stream,
        )
    if err:
        msg = lib.sparse_packed_attention_error_string(err).decode()
        raise RuntimeError(f"sparse_packed_attention launch failed: {msg} ({err})")
    _build.count_launch(sparse_packed_attention)
    return result


sparse_packed_attention.launches = 0


BWD_CHUNK = 512  # query rows per chunk of the plain backward (JAX's bwd_chunk)


def sparse_packed_attention_bwd_plain(q, k, v, out, lse, dout, ids, scale, chunk=BWD_CHUNK,
                                      *, out_lo):
    """The backward kernels' function in plain PyTorch, the same formulas:
    P = exp(S - lse) on the visible pairs (S = q k^T scale), Delta =
    rowsum(dO o O), dV = P^T dO, dS = P o (dO V^T - Delta), dQ = dS K scale,
    dK = dS^T Q scale; P and dS rounded to q's dtype where the kernels feed
    them to a product, every sum in fp32. q/out/dout [S, H, D], k/v [S, KH,
    D], lse [H, S] and out_lo (out's rounding residual) the forward's
    (`for_backward`), ids (document, fan, noise); O = out + out_lo. Chunked
    over `chunk` query rows, each against the keys of its rows' documents
    (`ops.chunked.key_ranges`), so memory stays O(chunk * S). Rows of
    padding (document 0) take part in no pair, whatever they hold, and get
    an exact 0. Returns (dq, dk, dv) in q's dtype."""
    doc, fan, noise = ids
    s, h, d = q.shape
    kh = k.shape[1]
    g = h // kh
    dtype = q.dtype
    live = (doc != 0)[:, None, None]
    q, k, v, dout = (torch.where(live, t, 0).float() for t in (q, k, v, dout))
    o = out.float() + out_lo.float()
    delta = torch.where(doc != 0, (dout * o).sum(-1).T, 0.0).reshape(kh, g, s)
    lse = lse.reshape(kh, g, s)
    qg, dog = q.reshape(s, kh, g, d), dout.reshape(s, kh, g, d)
    pos = torch.arange(s, dtype=torch.int32, device=q.device)
    dq = torch.zeros_like(qg)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    with torch.autocast(q.device.type, enabled=False):
        for lo, (k_lo, k_hi) in zip(range(0, s, chunk), key_ranges(doc, chunk)):
            if k_hi <= k_lo:  # padding rows only: no pair
                continue
            sl, ks = slice(lo, lo + chunk), slice(k_lo, k_hi)
            mask = chunk_mask(doc[sl], fan[sl], noise[sl], pos[sl], doc[ks], fan[ks], noise[ks],
                              k_lo)
            logits = torch.einsum("qhgd,khd->hgqk", qg[sl], k[ks]) * scale
            p = torch.where(mask, torch.exp(logits - lse[:, :, sl, None]), 0.0)
            dv[ks] += torch.einsum("hgqk,qhgd->khd", p.to(dtype).float(), dog[sl])
            dp = torch.einsum("qhgd,khd->hgqk", dog[sl], v[ks])
            ds = (p * (dp - delta[:, :, sl, None])).to(dtype).float()
            dq[sl] = torch.einsum("hgqk,khd->qhgd", ds, k[ks]) * scale
            dk[ks] += torch.einsum("hgqk,qhgd->khd", ds, qg[sl]) * scale
    return dq.reshape(s, h, d).to(dtype), dk.to(dtype), dv.to(dtype)


def sparse_packed_attention_bwd(
    q: torch.Tensor,  # [S, H, D]
    k: torch.Tensor,  # [S, KH, D]
    v: torch.Tensor,
    out: torch.Tensor,  # [S, H, D]: the forward's output
    lse: torch.Tensor,  # [H, S] fp32: the forward's logsumexp
    dout: torch.Tensor,  # [S, H, D]: the output's gradient
    ids: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # document, fan, noise [S] int32
    *,
    scale: Optional[float] = None,
    tables: Optional[KernelTables] = None,
    chunk: int = BWD_CHUNK,
    out_lo: torch.Tensor,  # [S, H, D]: the forward's rounding residual of out
):
    """(dq, dk, dv) of `sparse_packed_attention`'s output, from what its
    call with `for_backward` returned; Delta = rowsum(dO o (out +
    out_lo)). On CUDA tensors
    the hand-written backward kernels (three launches: Delta, dK/dV, dQ) or
    a raise; on CPU tensors the plain twin, in chunks of `chunk` query rows.
    `dout` may be any strided view: where the kernels' TMA cannot read it
    (an expanded gradient, an odd stride), one contiguous copy is made.
    `tables` as for `sparse_packed_attention`.

    `sparse_packed_attention_bwd.launches` counts calls that launched the
    kernels (one a call)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return sparse_packed_attention_bwd_plain(q, k, v, out, lse, dout, ids, scale, chunk,
                                                 out_lo=out_lo)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    document_id, fan_id, noise_id = ids
    _check(q, k, v, dict(document_id=document_id, fan_id=fan_id, noise_id=noise_id))
    s, h, d = q.shape
    kh = k.shape[1]
    if dout.shape != q.shape or dout.device != q.device:
        raise ValueError(f"dout {tuple(dout.shape)} on {dout.device} must match q "
                         f"{tuple(q.shape)} on {q.device}")
    for name, t in (("out", out), ("dout", dout)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernel takes bf16; {name} is {t.dtype}")
    if not _tma_ok(dout):
        dout = dout.contiguous()
    if out.shape != q.shape or not _tma_ok(out):
        raise ValueError(f"out must be the forward's [S, H, D] output, got {tuple(out.shape)} "
                         f"strides {out.stride()}")
    if (out_lo.dtype != out.dtype or out_lo.device != out.device or out_lo.shape != out.shape
            or out_lo.stride() != out.stride()):
        raise ValueError("out_lo must be the forward's residual: out's dtype, shape and strides")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (h, s) or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"lse must be the forward's contiguous fp32 [{h}, {s}] logsumexp, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    dq = torch.empty((s, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((s, kh, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((s, kh, d), dtype=q.dtype, device=q.device)
    if s == 0:
        return dq, dk, dv
    if not scale > 0:
        raise ValueError(f"the kernel takes a positive scale, got {scale}")
    if tables is None:
        tables = kernel_tables(*ids)
    _check_tables(tables, s, q.device)
    delta = torch.empty((h, s), dtype=torch.float32, device=q.device)
    lib = _library(BWD_KERNEL)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sparse_packed_attention_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            out_lo.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            document_id.data_ptr(), fan_id.data_ptr(), noise_id.data_ptr(),
            *(t.data_ptr() for t in tables),
            s, h, kh, d, tables.entries.shape[1],
            *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], *out.stride()[:2],
            *dout.stride()[:2], scale, stream,
        )
    if err:
        msg = lib.sparse_packed_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"sparse_packed_attention_bwd launch failed: {msg} ({err})")
    _build.count_launch(sparse_packed_attention_bwd)
    return dq, dk, dv


sparse_packed_attention_bwd.launches = 0


class _SparsePackedAttention(torch.autograd.Function):
    """Forward: `sparse_packed_attention` with its logsumexp and the
    output's rounding residual (the kernel on CUDA, its plain version on
    the CPU). Backward:
    `sparse_packed_attention_bwd` (the backward kernels on CUDA, their plain
    twin on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, document_id, fan_id, noise_id, scale, tables, bwd_chunk):
        if tables is None and q.device.type == "cuda":
            tables = kernel_tables(document_id, fan_id, noise_id)  # shared with the backward
        out, lse, out_lo = sparse_packed_attention(q, k, v, document_id, fan_id, noise_id,
                                                   scale=scale, tables=tables, for_backward=True)
        ctx.save_for_backward(q, k, v, out, out_lo, lse, document_id, fan_id, noise_id)
        ctx.scale, ctx.tables, ctx.bwd_chunk = scale, tables, bwd_chunk
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, out_lo, lse, *ids = ctx.saved_tensors
        dq, dk, dv = sparse_packed_attention_bwd(q, k, v, out, lse, g, tuple(ids), scale=ctx.scale,
                                                 tables=ctx.tables, chunk=ctx.bwd_chunk,
                                                 out_lo=out_lo)
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
    tables: Optional[KernelTables] = None,
    bwd_chunk: int = BWD_CHUNK,
) -> torch.Tensor:
    """`sparse_packed_attention` with a gradient for q, k and v. On CUDA
    tensors the forward and the backward launch their kernels (or raise, as
    the forward-only call does); on CPU tensors both take their plain
    versions, the backward in chunks of `bwd_chunk` query rows (the last one
    shorter where `bwd_chunk` does not divide S: JAX's scan needs equal
    chunks and recomputes all S rows at once there, the same gradient at
    O(S^2) memory). `tables` as for `sparse_packed_attention`: built once
    and shared by the layers that use the same ids (and by a remat
    recompute)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _SparsePackedAttention.apply(q, k, v, document_id, fan_id, noise_id,
                                        scale, tables, bwd_chunk)
