"""Masked attention and the cache-block mask (port of bagel_tpu/ops/attention.py).

`dot_attention` is the plain attention every kernel of this package is held
against: fp32 logits and softmax, GQA by reshape. The segment and training
masks come with the understanding and training slices.
"""

from __future__ import annotations

from typing import Optional

import torch


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
    Rows with no visible key give 0, not NaN. Returns [B, Sq, H, D] in
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
