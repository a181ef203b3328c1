"""GPipe pipeline parallelism over the MoT decoder stack (port of
bagel_tpu/parallel/pipeline.py).

- The stacked layer tree [L, ...] is split stage-major, [pp, L/pp, ...]
  (`stage_layers`); the rank at coordinate s of the stage axis runs stage
  s's L/pp layers (`parallel.mesh.Layout(pipeline_axis=)` keeps only them).
- The rows of a stacked packed batch are the microbatches. Every stage runs
  in lockstep over B + pp - 1 ticks: at tick t stage s runs microbatch
  t - s, and hands its output to stage s + 1 with `mesh.ring_permute` (a
  batch of isend/irecv; its backward is the reverse rotation, JAX's
  transpose of `lax.ppermute`). Stage 0 draws fresh microbatches; the last
  stage keeps the finished ones.
- The ticks of the bubble (t - s outside [0, B)) run nothing: JAX computes
  them on clamped inputs and drops the result. Their hand-overs still run
  (zeros), so that every stage permutes at every tick and the backward's
  reverse permutes pair up tick by tick: each received block enters the
  next tick's input (stage 0 adds it times 0), the last one the output;
  every stage adds its tick's input sequence too (times 0 past stage 0), so
  that the input's gradient all-reduce runs on every stage.
- The finished microbatches are all-reduced from the last stage (a masked
  sum, identity backward: every stage then computes the same heads), and
  the assembled input sequences enter through an identity whose gradient
  is all-reduced (only stage 0 consumes them), so each replicated leaf
  takes the same gradient on every stage.

Composition as in JAX: the stage axis holds layers, not data (dp = 1);
within a stage nothing is sharded.
"""

from __future__ import annotations

from typing import Optional

import torch

from bagel_tpu_torch.configs import Qwen2Config
from bagel_tpu_torch.parallel.mesh import copy_to_group, reduce_from_group, ring_permute


def stage_layers(params_layers: dict, pp: int) -> dict:
    """[L, ...] stacked layer tree -> [pp, L/pp, ...] stage-major."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        L = node.shape[0]
        if L % pp:
            raise ValueError(f"{L} layers not divisible into {pp} stages")
        return node.reshape((pp, L // pp) + tuple(node.shape[1:]))
    return walk(params_layers)


def pipeline_llm_forward_train(
    params: dict,
    cfg: Qwen2Config,
    seqs: torch.Tensor,  # [B, S, d] assembled microbatch embeddings
    position_ids: torch.Tensor,  # [B, S]
    gen_masks: torch.Tensor,  # [B, S] bool
    masks: Optional[torch.Tensor],  # [B, S, S] bool dense train masks
    mesh,
    axis: str = "pp",
    remat="full",
    mask_meta=None,  # (doc_id, fan_id, noise_id) each [B, S]; chunked attention
    attn_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Pipelined packed training forward over B microbatches: the math of
    `qwen2.llm_forward_train` on each row, with the layer stack split over
    the `axis` mesh dim: `params["layers"]` holds this stage's L/pp layers
    (`shard_params` under `Layout(pipeline_axis=axis)`). Returns the final
    hidden states [B, S, d] (post final norm, per expert), replicated over
    the stage axis."""
    from bagel_tpu_torch.models import qwen2
    from bagel_tpu_torch.ops.norms import rms_norm
    from bagel_tpu_torch.ops.rope import rope_cos_sin

    pp, stage = mesh.size(axis), mesh.index(axis)
    group = mesh.group(axis)
    B = seqs.shape[0]
    if attn_chunk is not None and mask_meta is None:
        raise ValueError("attn_chunk needs (doc, fan, noise)")
    if attn_chunk is None and masks is None:
        raise ValueError("the dense attention path needs the [B, S, S] masks")
    n_local = cfg.num_hidden_layers // pp
    first = params["layers"]
    while isinstance(first, dict):
        first = next(iter(first.values()))
    if cfg.num_hidden_layers % pp or first.shape[0] != n_local:
        raise ValueError(f"stage {stage} of {pp} takes {cfg.num_hidden_layers} / {pp} layers, "
                         f"the stack holds {first.shape[0]}: shard the parameters with "
                         f"parallel.mesh.Layout(mesh, cfg, pipeline_axis='{axis}')")
    per_layer = [{} for _ in range(n_local)]
    qwen2._unbind_into(params["layers"], per_layer)
    gen_masks = gen_masks.bool()

    def freeze_und(z, gm):
        return qwen2._select(gm, z, z.detach()) if cfg.freeze_und else z

    seqs = copy_to_group(torch.stack([freeze_und(seqs[m], gen_masks[m]) for m in range(B)]),
                         group)

    def run_stage(x, m):
        gm = gen_masks[m]
        rows = (torch.nonzero(~gm)[:, 0], torch.nonzero(gm)[:, 0])
        cos, sin = rope_cos_sin(position_ids[m], cfg.head_dim, cfg.rope_theta)
        meta = tuple(t[m] for t in mask_meta) if mask_meta is not None else None
        attend = qwen2._train_attend(masks[m] if masks is not None else None, meta,
                                     attn_chunk, None, None, x.device)

        def body(xc, lp):
            return qwen2.train_layer_block(cfg, lp, xc, attend, rows, cos, sin)

        body = qwen2.remat_wrap(body, remat)
        for lp in per_layer:
            x = body(x, lp)
        return x

    h_prev = torch.zeros_like(seqs[0])
    outputs = [torch.zeros_like(seqs[0]) for _ in range(B)]
    for t in range(B + pp - 1):
        m = t - stage  # the microbatch this stage runs at tick t
        x0 = seqs[min(max(m, 0), B - 1)]
        x = x0 + 0 * h_prev if stage == 0 else h_prev + 0 * x0
        y = run_stage(x, m) if 0 <= m < B else 0 * x
        if stage == pp - 1 and 0 <= m < B:
            outputs[m] = y
        h_prev = ring_permute(y, group)
    # the last hand-over reaches stage 0, which reads it times 0
    outputs[0] = outputs[0] + 0 * h_prev
    hidden = reduce_from_group(torch.stack(outputs) if stage == pp - 1
                               else torch.stack(outputs) * 0, group)

    eps = cfg.rms_norm_eps
    out = []
    for m in range(B):  # final norm and expert select, the same on every stage
        x, gm = hidden[m], gen_masks[m]
        if cfg.use_moe:
            out.append(qwen2._select(gm, rms_norm(x, params["final_norm_gen"], eps),
                                     freeze_und(rms_norm(x, params["final_norm"], eps), gm)))
        else:
            out.append(rms_norm(x, params["final_norm"], eps))
    return torch.stack(out)
