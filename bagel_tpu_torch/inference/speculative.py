"""Prompt-lookup speculative decoding, greedy-exact (port of
bagel_tpu/inference/speculative.py).

A decode step reads every weight of the und expert to make one token;
verifying a block of K + 1 tokens reads the same weights. So the draft here
is prompt lookup (n-gram): propose the K tokens that followed the latest
earlier occurrence of the history's trailing n-gram, then verify them in one
causal block of K + 1 through `llm_extend`. The verify accepts exactly the
prefix greedy decoding would have produced, so the output is
token-identical to `qwen2.decode_text` greedy decoding in exact arithmetic
(in low precision a (K+1)-row product may sum in another order than a
one-row one and flip a near tie; the tests hold it in fp32).

Each row accepts its own number of drafts: the cache's length is per row,
and the rejected tail of a verify block is rolled back by lowering that
row's length (the K/V written past it are dead). The loop is eager; the
shapes are the JAX package's static ones (a [B, C] history buffer, a K + 1
verify block for every row, rows that are done or out of budget ride along
with q_valid = 0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from bagel_tpu_torch.configs import Qwen2Config
from bagel_tpu_torch.models.qwen2 import KVCache, embed_tokens, llm_extend, lm_logits


def ngram_propose(ctx: torch.Tensor, ctx_len: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """[B, k] drafts: the continuation of the latest earlier match of each
    row's trailing n-gram (the tokens ctx[len - n : len]) in its history
    ctx [B, C]. A row without a match proposes ctx[0 : k]: a wrong draft is
    only rejected. Slices clamp into the buffer as JAX's dynamic_slice
    does."""
    b, c = ctx.shape
    dev = ctx.device
    j = torch.arange(c - n + 1, device=dev)
    grams = torch.arange(n, device=dev)
    win = ctx[:, j[:, None] + grams[None, :]]  # [B, C-n+1, n]
    lstart = torch.clamp(ctx_len.to(torch.int64) - n, 0, c - n)
    last = torch.gather(ctx, 1, lstart[:, None] + grams[None, :])  # [B, n]
    m = (win == last[:, None, :]).all(dim=-1)
    # windows wholly inside the history, the trailing gram itself excluded
    m = m & (j[None, :] + n <= ctx_len.to(torch.int64)[:, None] - 1)
    best = torch.where(m, j[None, :], -1).amax(dim=1)
    start = torch.clamp(torch.where(best >= 0, best + n, 0), 0, c - k)
    return torch.gather(ctx, 1, start[:, None] + torch.arange(k, device=dev)[None, :])


def _scatter_rows(buf: torch.Tensor, cols: torch.Tensor, keep: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """buf with buf[r, cols[r, i]] = src[r, i] where keep[r, i]; the other
    entries land in a scratch column past the end and are dropped (JAX's
    mode="drop")."""
    pad = torch.cat([buf, buf[:, :1]], dim=1)
    idx = torch.where(keep, cols, buf.shape[1])
    return pad.scatter(1, idx, src.to(buf.dtype))[:, : buf.shape[1]]


def decode_text_spec(
    params: dict,
    cfg: Qwen2Config,
    cache: KVCache,
    start_tokens: torch.Tensor,  # [B]
    position_ids: torch.Tensor,  # [B] rope position of the start token
    ctx_tokens: torch.Tensor,  # [B, C0] consumed text ids (the prompt history)
    ctx_len: torch.Tensor,  # [B] valid prefix of ctx_tokens
    *,
    max_steps: int,
    eos_id: int,
    draft_len: int = 7,
    ngram: int = 3,
    active: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    in_place: bool = False,
    stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Greedy decode with prompt-lookup speculation: the tokens of
    `decode_text(..., do_sample=False)` ([B, max_steps], eos-padded) and the
    final cache.

    Each verify writes draft_len + 1 entries past a row's length before the
    rollback, so the caller leaves that much room beyond what plain decode
    needs (`llm_extend` raises on a write past the buffer). No row emits
    past max_steps, and its cache holds exactly the tokens it consumed: a
    chunked caller (the serving runtime) relies on both. `active`,
    `in_place` and `stats` (its "forwards": the verify forwards) as in
    `decode_text`.
    """
    b = start_tokens.shape[0]
    dev = start_tokens.device
    k = draft_len
    if not in_place:
        cache = cache.clone()
    c0 = ctx_tokens.shape[1]
    cbuf = c0 + max_steps + k + 2  # history + start + generated + slack
    rows = torch.arange(b, device=dev)
    ctx_len = ctx_len.to(device=dev, dtype=torch.int64)
    ctx = torch.zeros((b, cbuf), dtype=torch.int64, device=dev)
    ctx[:, :c0] = ctx_tokens.to(device=dev, dtype=torch.int64)
    ctx[rows, ctx_len] = start_tokens.to(torch.int64)  # the start token joins the history
    hist_len = ctx_len + 1

    done = ~active if active is not None else torch.zeros(b, dtype=torch.bool, device=dev)
    out = torch.full((b, max_steps + k + 1), eos_id, dtype=torch.int64, device=dev)
    out_len = torch.zeros(b, dtype=torch.int64, device=dev)
    cur = start_tokens.to(torch.int64)
    pos = position_ids
    jj = torch.arange(k + 1, device=dev)[None, :]
    while not bool((done | (out_len >= max_steps)).all()):
        draft = ngram_propose(ctx, hist_len, ngram, k)  # [B, k]
        block = torch.cat([cur[:, None], draft], dim=1)  # [B, k + 1]
        live = ~(done | (out_len >= max_steps))
        q_valid = torch.where(live, k + 1, 0).to(torch.int32)
        hidden, cache = llm_extend(
            params, cfg, embed_tokens(params, block), pos[:, None] + jj.to(pos.dtype), cache,
            q_valid, und_len=k + 1, causal=True, update_cache=True, attn_impl=attn_impl,
            in_place=True,
        )
        y = lm_logits(params, hidden.reshape(b * (k + 1), -1)).argmax(dim=-1).reshape(b, k + 1)

        # the longest accepted draft prefix, cut at the first eos
        a = torch.cumprod((draft == y[:, :k]).to(torch.int64), dim=1).sum(dim=1)
        is_eos = (y == eos_id) & (jj <= a[:, None])
        e = torch.where(is_eos.any(dim=1), is_eos.to(torch.int64).argmax(dim=1), k)
        n_emit = torch.where(live, torch.minimum(a, e) + 1, 0)
        # never emit (or keep cache entries) past the step budget
        n_emit = torch.minimum(n_emit, torch.clamp(max_steps - out_len, min=0))

        emit = jj < n_emit[:, None]
        out = _scatter_rows(out, out_len[:, None] + jj, emit, y)
        ctx = _scatter_rows(ctx, hist_len[:, None] + jj, emit, y)

        # roll back the rejected entries: the block wrote k + 1, and only
        # n_emit inputs (cur and the accepted drafts) were consumed
        back = torch.where(live, (k + 1) - n_emit, 0).to(cache.length.dtype)
        cache = dataclasses.replace(cache, length=cache.length - back)

        y_last = y[rows, torch.clamp(n_emit - 1, min=0)]
        cur = torch.where(live, y_last, cur)
        done = done | (live & (y_last == eos_id))
        out_len = out_len + n_emit
        pos = pos + n_emit.to(pos.dtype)
        hist_len = hist_len + n_emit
        if stats is not None:
            stats["forwards"] = stats.get("forwards", 0) + 1
    return out[:, :max_steps].to(start_tokens.dtype), cache
