"""Ring attention: context parallelism over a process group (port of
bagel_tpu/ops/ring.py).

The sequence is sharded over the ranks of `group`: rank i holds global
positions [i * S_local, (i + 1) * S_local). Q stays local while the K/V
blocks (and, for the packed mask, their ids) rotate around the ring
(`parallel.mesh.ring_permute`: a batch of isend/irecv, whose backward is
the reverse rotation), and each step folds the block's online-softmax
partials into the running (m, l, acc). Exact against the dense mask.

Plain PyTorch, as XLA lowers it in JAX: the scores are fp32 products of the
upcast inputs (autocast off), the unnormalized probabilities are rounded to
v's dtype before the PV product, as JAX's `p.astype(v_blk.dtype)`. A block
materializes [B, KH, G, Sq, Sk] fp32 scores; `q_chunk` computes it in
chunks of query rows, each under `torch.utils.checkpoint` (its scores are
recomputed in the backward), so memory is O(q_chunk * Sk).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from bagel_tpu_torch.parallel.mesh import group_rank, group_size, permute, ring_permute

NEG_INF = -1e30


def _block(qf, k_blk, v_blk, mask, scale):
    """(m_b, l_b, acc_b) of q rows against one K/V block; qf [B, Sq, KH, G,
    D], mask [Sq, Sk] bool or None."""
    with torch.autocast(qf.device.type, enabled=False):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf.float(), k_blk.float()) * scale
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        m_b = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m_b)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        l_b = p.sum(dim=-1, keepdim=True)
        acc_b = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_blk.dtype).float(), v_blk.float())
    return m_b, l_b, acc_b


def _ring(q, k, v, group, scale, q_chunk, mask_fn, ids=None):
    """The ring loop of both variants: mask_fn(rows, owner, ids_blk) -> the
    [rows, Sk] mask (or None) of local query rows `rows` against the K/V
    block of rank `owner`."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    if scale is None:
        scale = d**-0.5
    n, me = group_size(group), group_rank(group)
    qf = q.reshape(b, sq, kh, g, d)
    c = q_chunk or sq
    chunks = [slice(lo, min(lo + c, sq)) for lo in range(0, sq, c)]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    state = []
    for sl in chunks:
        rows = sl.stop - sl.start
        state.append((torch.full((b, kh, g, rows, 1), NEG_INF, device=q.device),
                      torch.zeros((b, kh, g, rows, 1), device=q.device),
                      torch.zeros((b, kh, g, rows, d), device=q.device)))
    k_blk, v_blk, ids_blk = k, v, ids
    for step in range(n):
        owner = (me - step) % n
        for j, sl in enumerate(chunks):
            mask = mask_fn(sl, owner, ids_blk)
            args = (qf[:, sl], k_blk, v_blk, mask, scale)
            m_b, l_b, acc_b = (checkpoint(_block, *args, use_reentrant=False)
                               if grad and q_chunk else _block(*args))
            m, l, acc = state[j]
            m_new = torch.maximum(m, m_b)
            alpha, beta = torch.exp(m - m_new), torch.exp(m_b - m_new)
            state[j] = (m_new, l * alpha + l_b * beta, acc * alpha + acc_b * beta)
        if step < n - 1:
            k_blk, v_blk = ring_permute(k_blk, group), ring_permute(v_blk, group)
            if ids_blk is not None:
                ids_blk = tuple(permute(t, group) for t in ids_blk)
    out = torch.cat([acc / l.clamp_min(1e-20) for _, l, acc in state], dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def ring_attention(
    q: torch.Tensor,  # [B, Sq_local, H, D]
    k: torch.Tensor,  # [B, Skv_local, KH, D]
    v: torch.Tensor,
    group,
    causal: bool = False,
    scale: Optional[float] = None,
    q_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Exact GQA attention over a sequence sharded on the ranks of `group`
    (None: one rank). Causal masking uses global positions."""
    sq, skv = q.shape[1], k.shape[1]
    me = group_rank(group)

    def mask_fn(sl, owner, _):
        if not causal:
            return None
        q_pos = me * sq + torch.arange(sl.start, sl.stop, device=q.device)
        k_pos = owner * skv + torch.arange(skv, device=q.device)
        return q_pos[:, None] >= k_pos[None, :]

    return _ring(q, k, v, group, scale, q_chunk, mask_fn)


def ring_packed_attention(
    q: torch.Tensor,  # [B, S_local, H, D]
    k: torch.Tensor,  # [B, S_local, KH, D]
    v: torch.Tensor,
    doc_id: torch.Tensor,  # [S_local] per-token sample id (0 = padding)
    fan_id: torch.Tensor,  # [S_local] full/noise split id, -1 elsewhere
    noise_id: torch.Tensor,  # [S_local] noise split id, -1 elsewhere
    group,
    scale: Optional[float] = None,
    q_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Ring attention under the packed-training mask predicate
    (`ops.attention.train_packed_mask`): the sequence and its ids sharded
    over `group`; the key blocks' ids rotate with K/V."""
    sq = q.shape[1]
    me = group_rank(group)

    def mask_fn(sl, owner, ids_blk):
        doc_k, fan_k, noi_k = ids_blk
        doc_q, fan_q, noi_q = doc_id[sl], fan_id[sl], noise_id[sl]
        q_pos = me * sq + torch.arange(sl.start, sl.stop, device=q.device)
        k_pos = owner * sq + torch.arange(sq, device=q.device)
        causal = q_pos[:, None] >= k_pos[None, :]
        same_fan = (fan_q[:, None] == fan_k[None, :]) & (fan_q[:, None] >= 0)
        remove_noise = ~((noi_k[None, :] >= 0) & (noi_q[:, None] != noi_k[None, :]))
        same_doc = (doc_q[:, None] == doc_k[None, :]) & (doc_q[:, None] != 0)
        return same_doc & (causal | same_fan) & remove_noise

    return _ring(q, k, v, group, scale, q_chunk, mask_fn, (doc_id, fan_id, noise_id))
