"""Masked attention and its masks (port of bagel_tpu/ops/attention.py).

`dot_attention` is the plain attention every kernel of this package is held
against: fp32 logits and softmax, GQA by reshape. Mask builders (bool, True
= may attend): `cache_block_mask` (a block over a KV buffer),
`segment_mask` (the ViT's per-image full attention) and `train_packed_mask`
(the packed causal/full/noise/document predicate); `mask_to_bias` turns a
mask into an additive bias.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float("-inf")


def dot_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked multi-head attention with GQA.

    Args:
      q: [B, Sq, H, D]
      k: [B, Skv, KH, D] with H % KH == 0
      v: [B, Skv, KH, D]
      mask: bool, [Sq, Skv] or [B, Sq, Skv]; True = may attend.
      scale: defaults to D**-0.5.

    Both products take inputs of the working dtype and give fp32 results
    (the inputs are upcast: a bf16 torch.matmul would round its output to
    bf16). The probabilities are cast to v.dtype before the PV product.
    Rows with no visible key give 0, not NaN (and a zero gradient). Returns [B, Sq, H, D] in
    q.dtype.
    """
    b, sq, h, d = q.shape
    _, skv, kh, _ = k.shape
    g = h // kh
    if scale is None:
        scale = d**-0.5

    qf = q.reshape(b, sq, kh, g, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())  # fp32
    logits.mul_(scale)
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[None]
        logits.masked_fill_(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    del logits
    if probs.requires_grad:  # softmax's backward reads its output: no in-place edit
        probs = probs.nan_to_num(nan=0.0)
    else:
        probs.nan_to_num_(nan=0.0)  # softmax over an all -inf row
    out = torch.einsum(
        "bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float()
    )
    return out.reshape(b, sq, h, d).to(q.dtype)


def cache_block_mask(
    kv_buf_len: int,
    block_len: int,
    past_len: torch.Tensor,
    q_valid_len: torch.Tensor,
    causal: bool,
) -> torch.Tensor:
    """Mask for a new block of queries attending over a KV buffer.

    The buffer holds `past_len[b]` past tokens at [0, past_len) and the new
    block at [past_len, past_len + block_len). Every query sees all past
    tokens; within the block, `causal=True` aligns the diagonal at the block
    start. Keys beyond the written region are never visible and padded
    queries (index >= q_valid_len) see nothing.

    Returns bool [B, Sq, Skv].
    """
    dev = past_len.device
    qi = torch.arange(block_len, dtype=torch.int32, device=dev)[None, :, None]
    kj = torch.arange(kv_buf_len, dtype=torch.int32, device=dev)[None, None, :]
    past = past_len.to(torch.int32)[:, None, None]
    valid = q_valid_len.to(torch.int32)[:, None, None]
    if causal:
        visible = kj <= past + qi
    else:
        visible = kj < past + valid
    return visible & (kj < past + valid) & (qi < valid)


def segment_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """Full attention within equal segments; id 0 = padding (no attention).

    segment_ids: [B, S] int. Returns bool [B, S, S]."""
    a = segment_ids[:, :, None]
    b = segment_ids[:, None, :]
    return (a == b) & (a != 0)


def train_packed_mask(
    document_id: torch.Tensor,
    full_and_noise_id: torch.Tensor,
    noise_id: torch.Tensor,
) -> torch.Tensor:
    """Composed mask over a packed sequence (all args [S] int):

      allowed(i, j) = same_document (id != 0)
                      & (i >= j | same full/noise split (id >= 0))
                      & !(key j is a noise token of another noise split)

    Returns bool [S, S]."""
    s = document_id.shape[0]
    dev = document_id.device
    i = torch.arange(s, device=dev)[:, None]
    j = torch.arange(s, device=dev)[None, :]
    fan_q, fan_k = full_and_noise_id[:, None], full_and_noise_id[None, :]
    same_fan = (fan_q == fan_k) & (fan_q >= 0)
    noise_q, noise_k = noise_id[:, None], noise_id[None, :]
    remove_noise = ~((noise_k >= 0) & (noise_q != noise_k))
    doc_q = document_id[:, None]
    same_doc = (doc_q == document_id[None, :]) & (doc_q != 0)
    return same_doc & ((i >= j) | same_fan) & remove_noise


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """bool mask -> additive bias (0 / NEG_INF), the reference's
    nested_attention_masks representation (upstream data_utils.py:99-101)."""
    return torch.where(mask, 0.0, NEG_INF).to(dtype)
