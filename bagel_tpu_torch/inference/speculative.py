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
row's length (the K/V written past it are dead). The shapes are the JAX
package's static ones (a [B, C] history buffer, a K + 1 verify block for
every row, rows that are done or out of budget ride along with q_valid =
0), and JAX's while_loop runs as chunks of `spec_verify` on static tensors
(`SpecState`) through a `DecodeProgram`: a CUDA-graph replay a chunk on
CUDA tensors.
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


@dataclasses.dataclass
class SpecState:
    """The static tensors of a verify (JAX's while_loop carry), updated in
    place: the input token `cur`, its position, `done`, the tokens emitted
    `out_len` [B], the step budget `limit` [1] on the device, the output
    `out` [B, W + 1] and the lookup history `ctx` [B, C + 1] with its length
    `hist_len` (each with a last, scratch column that takes the writes JAX
    drops), and the cache, whose `length` is the state's own."""

    cache: KVCache
    cur: torch.Tensor
    pos: torch.Tensor
    done: torch.Tensor
    out_len: torch.Tensor
    limit: torch.Tensor
    out: torch.Tensor
    ctx: torch.Tensor
    hist_len: torch.Tensor


PREFIX_STEPS = 4  # the int8 verify's prefix bounds: quarters of the buffer


def prefix_bound(need: int, s_max: int) -> int:
    """The dequantized prefix of an int8 cache's verifies for a decode whose
    lengths stay within `need`: the next of PREFIX_STEPS fixed bounds of an
    s_max-slot buffer (a quarter, a half, ...). A key of the program's
    graphs, so that a serving run, whose longest row grows chunk by chunk,
    captures at most PREFIX_STEPS verify graphs; the cost is up to a quarter
    of the buffer dequantized past the live keys."""
    step = -(-s_max // PREFIX_STEPS)
    return min(-(-need // step) * step, s_max)


def spec_verify(params: dict, cfg: Qwen2Config, st: SpecState, *, draft_len: int, ngram: int,
                eos_id: int, attn_impl: str, kv_bound: int, layout=None) -> None:
    """One verify of JAX's speculative loop on `st`, with no read back to the
    host: draft from the history, one causal block of draft_len + 1 through
    the decoder, accept the longest agreeing prefix (cut at the first eos and
    at the budget), then write the emitted tokens and roll the rejected
    entries back. A row that is done or out of budget verifies with q_valid
    0 and emits nothing; once every row is, the verify also writes nothing
    into the cache (JAX's loop has left). `kv_bound`: a host bound on the
    cache lengths over the whole decode (an int8 cache's verify dequantizes
    that prefix). `layout`: sharded weights and cache (`qwen2.llm_extend`)."""
    b = st.cur.shape[0]
    k = draft_len
    dev = st.cur.device
    rows = torch.arange(b, device=dev)
    jj = torch.arange(k + 1, device=dev)[None, :]
    ctx = st.ctx[:, :-1]
    draft = ngram_propose(ctx, st.hist_len, ngram, k)  # [B, k]
    block = torch.cat([st.cur[:, None], draft], dim=1)  # [B, k + 1]
    live = ~(st.done | (st.out_len >= st.limit))
    q_valid = torch.where(live, k + 1, 0).to(torch.int32)
    hidden, new = llm_extend(
        params, cfg, embed_tokens(params, block, layout), st.pos[:, None] + jj.to(st.pos.dtype),
        st.cache, q_valid, und_len=k + 1, causal=True, update_cache=True, attn_impl=attn_impl,
        in_place=True, kv_bound=kv_bound, keep=live.any().expand(b), layout=layout,
    )
    y = lm_logits(params, hidden.reshape(b * (k + 1), -1), layout).argmax(dim=-1)
    y = y.reshape(b, k + 1)

    # the longest accepted draft prefix, cut at the first eos
    a = torch.cumprod((draft == y[:, :k]).to(torch.int64), dim=1).sum(dim=1)
    is_eos = (y == eos_id) & (jj <= a[:, None])
    e = torch.where(is_eos.any(dim=1), is_eos.to(torch.int64).argmax(dim=1), k)
    n_emit = torch.where(live, torch.minimum(a, e) + 1, 0)
    # never emit (or keep cache entries) past the step budget
    n_emit = torch.minimum(n_emit, torch.clamp(st.limit - st.out_len, min=0))

    emit = jj < n_emit[:, None]
    st.out.scatter_(1, torch.where(emit, st.out_len[:, None] + jj, st.out.shape[1] - 1), y)
    st.ctx.scatter_(1, torch.where(emit, st.hist_len[:, None] + jj, st.ctx.shape[1] - 1), y)

    # roll back the rejected entries: the block wrote k + 1, and only
    # n_emit inputs (cur and the accepted drafts) were consumed
    back = torch.where(live, (k + 1) - n_emit, 0).to(new.length.dtype)
    st.cache.length.copy_(new.length - back)

    y_last = y[rows, torch.clamp(n_emit - 1, min=0)]
    st.cur.copy_(torch.where(live, y_last, st.cur))
    st.done.copy_(st.done | (live & (y_last == eos_id)))
    st.out_len.add_(n_emit)
    st.pos.add_(n_emit.to(st.pos.dtype))
    st.hist_len.add_(n_emit)


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
    program=None,
    graph: bool = True,
    layout=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Greedy decode with prompt-lookup speculation: the tokens of
    `decode_text(..., do_sample=False)` ([B, max_steps], eos-padded) and the
    final cache.

    Each verify writes draft_len + 1 entries past a row's length before the
    rollback, so the caller leaves that much room beyond what plain decode
    needs (a live row that would write past the buffer raises after its
    chunk). No row emits past max_steps, and its cache holds exactly the
    tokens it consumed: a chunked caller (the serving runtime) relies on
    both. The verifies run through `program` as `decode_text`'s steps do
    (`spec_verify`, min(program.spec_chunk, max_steps) verifies a chunk); `active`,
    `in_place`, `stats` (its "forwards": the verify forwards run), `graph`
    and `layout` as in `decode_text`. The given cache's lengths are read once,
    before the first chunk: with draft_len + max_steps + 1 on top, rounded
    up by `prefix_bound`, they bound an int8 cache's dequantized prefix, a
    key of the program's graphs.
    """
    from bagel_tpu_torch.inference.decode_program import (
        DecodeProgram,
        buffers_key,
        weights_key,
    )

    b = start_tokens.shape[0]
    dev = start_tokens.device
    k = draft_len
    if max_steps <= 0:
        return torch.full((b, 0), eos_id, dtype=start_tokens.dtype, device=dev), cache
    prog = program if program is not None else DecodeProgram()
    with prog.lock:  # the program's static buffers are one caller's at a time
        n = min(prog.spec_chunk, max_steps)
        work = cache if in_place else prog.owned_copy(cache)
        s_max = work.max_len
        # an int8 cache's verify dequantizes a prefix that covers every length of
        # the decode; a bf16 verify reads the buffer itself
        bound = (prefix_bound(int(cache.length.max()) + max_steps + k + 1, s_max)
                 if work.k.dtype == torch.int8 else s_max)
        c0 = ctx_tokens.shape[1]
        width = max(s_max, max_steps)  # out: at most max_steps tokens a row
        cwidth = max(s_max, c0) + k + 2  # the history, its start token and emitted tokens
        key = ("spec", b, s_max, work.k.dtype, weights_key(params), n, k, ngram, eos_id, bound,
               width, cwidth, attn_impl)

        def make_state():
            def z(*shape, dtype=torch.int64):
                return torch.zeros(shape, dtype=dtype, device=dev)

            return SpecState(
                cache=dataclasses.replace(work, length=z(b, dtype=torch.int32)), cur=z(b), pos=z(b),
                done=z(b, dtype=torch.bool), out_len=z(b), limit=z(1), out=z(b, width + 1),
                ctx=z(b, cwidth + 1), hist_len=z(b))

        def make_step(st):
            return lambda i, gen: spec_verify(params, cfg, st, draft_len=k, ngram=ngram,
                                              eos_id=eos_id, attn_impl=attn_impl, kv_bound=bound,
                                              layout=layout)

        e = prog.entry(key, buffers_key(work), make_state, make_step,
                       lambda st: st.done.fill_(True), n=n, graph=graph and dev.type == "cuda",
                       sampling=False)
        st = e.state
        rows = torch.arange(b, device=dev)
        ctx_len = ctx_len.to(device=dev, dtype=torch.int64)
        st.cache.length.copy_(work.length)
        st.cur.copy_(start_tokens)
        st.pos.copy_(position_ids)
        st.done.copy_(~active if active is not None else torch.zeros_like(st.done))
        st.out_len.zero_()
        st.limit.fill_(max_steps)
        st.out.fill_(eos_id)
        st.ctx.zero_()
        st.ctx[:, :c0] = ctx_tokens
        st.ctx[rows, ctx_len] = start_tokens.to(torch.int64)  # the start token joins the history
        st.hist_len.copy_(ctx_len + 1)
        while True:
            prog.run(e, stats=stats)
            # the one host read of the chunk: the tokens so far, done, out_len, lengths
            rep = torch.cat([st.out[:, :max_steps], st.done[:, None].long(), st.out_len[:, None],
                             st.cache.length[:, None].long()], dim=1).cpu()
            if int(rep[:, -1].max()) > s_max:
                raise ValueError(f"KV buffer too small: a row's length reached "
                                 f"{int(rep[:, -1].max())} > {s_max}")
            if bool((rep[:, max_steps].bool() | (rep[:, max_steps + 1] >= max_steps)).all()):
                break
        return (rep[:, :max_steps].to(device=dev, dtype=start_tokens.dtype),
                dataclasses.replace(work, length=st.cache.length.clone()))
