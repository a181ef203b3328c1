"""Chunked packed-mask attention for training (port of bagel_tpu/ops/chunked.py).

Exact GQA attention under the packed training predicate

  visible(i, j) = same_doc & (i >= j | same_fan) & !(j is noise of another split)

(`ops.attention.train_packed_mask`) without the [S, S] mask: queries go in
chunks of `chunk` rows, each against the span of keys that share a
document with one of its rows (`key_ranges`: no other key is visible, so
the function is JAX's over all S keys), building its own slice of the mask
from the per-token ids. Each chunk runs under
`torch.utils.checkpoint`, so its logits are recomputed in the backward
rather than kept: memory O(chunk * S) both ways (JAX: `jax.checkpoint`
over a `lax.scan`). Plain PyTorch, as XLA lowers it in JAX; it serves
`--attn_chunk` (the block-sparse kernel's gradient is a kernel of its own:
`ops.sparse_flash.sparse_packed_attention_bwd`, whose plain twin reuses
`key_ranges` and `chunk_mask`).

Products are fp32 over the working-dtype inputs (the inputs are upcast, as
`dot_attention` does), the probabilities are cast to v's dtype before the
PV product, and autocast is off inside a chunk so that the logits stay
fp32. A row with no visible key gives 0.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def key_ranges(document_id: torch.Tensor, chunk: int) -> list:
    """[(k_lo, k_hi)] for each chunk of `chunk` query rows (the last may be
    shorter): the span of key positions that share a document with one of
    its rows (k_hi <= k_lo: the chunk is all padding). One read to the
    host."""
    s = document_id.shape[0]
    doc = document_id.long()
    pos = torch.arange(s, device=doc.device)
    n = int(doc.max()) + 1
    first = torch.full((n,), s, device=doc.device).scatter_reduce(0, doc, pos, "amin")
    last = torch.full((n,), -1, device=doc.device).scatter_reduce(0, doc, pos, "amax")
    live = doc != 0
    pad = -s % chunk  # a ragged last chunk: padded with rows that see nothing
    lo = torch.nn.functional.pad(torch.where(live, first[doc], s), (0, pad), value=s)
    hi = torch.nn.functional.pad(torch.where(live, last[doc] + 1, 0), (0, pad), value=0)
    return torch.stack([lo.view(-1, chunk).amin(dim=1), hi.view(-1, chunk).amax(dim=1)],
                       dim=1).tolist()


def chunk_mask(doc_q, fan_q, noi_q, q_pos, doc, fan, noi, k_start=0):
    """[bq, n] slice of train_packed_mask: rows q_pos, keys k_start.. of
    the key ids doc, fan, noi."""
    k_pos = torch.arange(k_start, k_start + doc.shape[0], dtype=q_pos.dtype, device=doc.device)
    causal = q_pos[:, None] >= k_pos[None, :]
    same_doc = (doc_q[:, None] == doc[None, :]) & (doc_q[:, None] != 0)
    same_fan = (fan_q[:, None] == fan[None, :]) & (fan_q[:, None] >= 0)
    remove_noise = ~((noi[None, :] >= 0) & (noi_q[:, None] != noi[None, :]))
    return same_doc & (causal | same_fan) & remove_noise


def chunk_attention(q_blk, kf, vf, doc_q, fan_q, noi_q, q_pos, doc, fan, noi, scale,
                    dtype, k_start=0):
    """One query chunk: q_blk [c, KH, G, D] against the fp32 upcasts kf, vf
    [n, KH, D] of the keys k_start.. of K/V of dtype `dtype` (doc, fan, noi
    their ids) -> [c, KH * G, D] in `dtype`. The probabilities are rounded
    to `dtype` before the PV product."""
    c, kh, g, d = q_blk.shape
    with torch.autocast(q_blk.device.type, enabled=False):
        mask = chunk_mask(doc_q, fan_q, noi_q, q_pos, doc, fan, noi, k_start)[None, None]
        logits = torch.einsum("qhgd,khd->hgqk", q_blk.float(), kf) * scale
        logits = torch.where(mask, logits, NEG_INF)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(logits - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        probs = (p / l.clamp_min(1e-20)).to(dtype)
        out = torch.einsum("hgqk,khd->qhgd", probs.float(), vf)
    return out.reshape(c, kh * g, d).to(dtype)


def chunked_packed_attention(
    q: torch.Tensor,  # [S, H, D]
    k: torch.Tensor,  # [S, KH, D]
    v: torch.Tensor,
    document_id: torch.Tensor,  # [S] int
    fan_id: torch.Tensor,
    noise_id: torch.Tensor,
    chunk: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact masked GQA attention, O(chunk * S) memory. S % chunk == 0.
    Returns [S, H, D] in q's dtype."""
    s, h, d = q.shape
    kh = k.shape[1]
    if scale is None:
        scale = d**-0.5
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide S = {s}")
    pos = torch.arange(s, dtype=torch.int32, device=q.device)
    qg = q.reshape(s, kh, h // kh, d)
    ids = (document_id, fan_id, noise_id)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    kf, vf = k.float(), v.float()  # one upcast: dK and dV sum over the chunks in fp32
    outs = []
    for lo, (k_lo, k_hi) in zip(range(0, s, chunk), key_ranges(document_id, chunk)):
        sl, ks = slice(lo, lo + chunk), slice(k_lo, k_hi)
        if k_hi <= k_lo:  # padding only: sees nothing
            outs.append(q.new_zeros((chunk, h, d)))
            continue
        args = (qg[sl], kf[ks], vf[ks], *(t[sl] for t in ids), pos[sl],
                *(t[ks] for t in ids), scale, q.dtype, k_lo)
        if grad:
            outs.append(checkpoint(chunk_attention, *args, use_reentrant=False))
        else:
            outs.append(chunk_attention(*args))
    return torch.cat(outs, dim=0)
