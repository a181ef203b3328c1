"""Expert parallelism (ep) for the MoT dual-expert decoder (port of
bagel_tpu/parallel/expert.py).

BAGEL's Mixture-of-Transformer-experts routes tokens by modality: the und
expert's weights see text and ViT tokens, the gen expert's the VAE tokens.
Expert parallelism splits the pair over a 2-way mesh axis:

- The paired expert subtrees (`attn`/`attn_gen`, `mlp`/`mlp_gen`,
  `input_ln`/`input_ln_gen`, `post_ln`/`post_ln_gen`) stack on a leading
  [2, L, ...] axis (`split_expert_layers`: und = 0) sharded over the axis:
  rank e holds expert e (`parallel.mesh.Layout(expert_axis=)`).
- The layer is `models.qwen2.train_layer_block`'s, with `ExpertParallel`
  in place of its per-expert split `_by_expert`: rank e runs only expert
  e's products, over its own tokens, and the dense path's modality select
  becomes a masked sum over the pair (each rank's values on its own
  tokens, zero elsewhere; all-reduce forward, identity backward) after
  the input norm and q/k/v, after o and after the FFN; the replicated
  stream enters each expert's products through an identity whose
  gradient is all-reduced (the two experts' gradients of the stream add
  up).
- The attention runs on the combined q/k/v, replicated on both ranks.
- `freeze_und`: the und rank zeroes the gradient of its contributions at
  the dense path's points (the normed q and k, v, o, the FFN), where the
  dense path detaches them: a zero gradient keeps the backward's
  collectives paired with the gen rank's.

Asserted as in JAX: the axis has size 2, the config has an expert pair, and
the path takes the dense-mask or `attn_chunk` attention, not `sparse_block`
(bagel_tpu/models/bagel.py:262-268).
"""

from __future__ import annotations

from typing import Optional

import torch

from bagel_tpu_torch.configs import Qwen2Config
from bagel_tpu_torch.models import qwen2
from bagel_tpu_torch.parallel.mesh import _EXPERT_PAIRS, copy_to_group, reduce_from_group


class _ZeroGrad(torch.autograd.Function):
    """Identity with a zero gradient: the und rank's frozen contributions.
    Not a detach: the graph stays whole, so the und rank runs every
    collective of the backward that the gen rank runs."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def split_expert_layers(layers: dict):
    """Partition a stacked-layer tree into (stacked, shared): stacked holds
    [2, L, ...] expert-paired leaves (und = index 0, the routing convention
    gen_mask=False -> und), shared the rest."""
    def stack(u, g):
        if isinstance(u, dict):
            return {k: stack(u[k], g[k]) for k in u}
        return torch.stack([u, g])

    stacked, taken = {}, set()
    for und_k, gen_k in _EXPERT_PAIRS:
        if und_k in layers and gen_k in layers:
            stacked[und_k] = stack(layers[und_k], layers[gen_k])
            taken |= {und_k, gen_k}
    if not stacked:
        raise ValueError("expert_parallel needs a dual-expert (mot/moe) config")
    return stacked, {k: v for k, v in layers.items() if k not in taken}


class ExpertParallel:
    """`train_layer_block`'s expert hooks for process `e` (0 = und, 1 = gen)
    of the 2-way `group`."""

    freeze = staticmethod(_ZeroGrad.apply)

    def __init__(self, group, e: int):
        self.group, self.e = group, e

    def by_expert(self, rows, x, fn_und, fn_gen):
        """`qwen2._by_expert` over the pair: this process's expert over its
        rows of the replicated x, merged with the other's by a masked sum."""
        mine = rows[self.e]
        out = (fn_gen if self.e else fn_und)(copy_to_group(x, self.group).index_select(0, mine))
        single = torch.is_tensor(out)
        merged = tuple(
            reduce_from_group(z.new_zeros((x.shape[0],) + z.shape[1:]).index_copy(0, mine, z),
                              self.group)
            for z in ((out,) if single else out))
        return merged[0] if single else merged


def ep_llm_forward_train(
    params: dict,
    cfg: Qwen2Config,
    packed: torch.Tensor,  # [S, d] assembled embeddings
    position_ids: torch.Tensor,  # [S]
    mask: Optional[torch.Tensor],  # [S, S] bool dense train mask
    gen_mask: torch.Tensor,  # [S] bool, True = gen-expert (VAE) token
    mesh,
    axis: str = "ep",
    remat="full",
    mask_meta=None,  # (doc_id, fan_id, noise_id); required for attn_chunk
    attn_chunk: Optional[int] = None,
    layout=None,
) -> torch.Tensor:
    """Expert-parallel packed training forward: `qwen2.llm_forward_train`
    with the expert pair split over the 2-way `axis`. `params["layers"]`
    holds both experts (this rank uses its own) or, under `layout`, this
    rank's shards (the other expert's leaves empty). Returns the final
    hidden states [S, d], replicated over the axis."""
    if mesh.size(axis) != 2:
        raise ValueError(f"expert_parallel needs axis '{axis}' of size 2 (und/gen), "
                         f"got {mesh.size(axis)}")
    layers = params["layers"]
    if not any(und in layers and gen in layers for und, gen in _EXPERT_PAIRS):
        raise ValueError("expert_parallel needs a dual-expert (mot/moe) config")
    return qwen2.llm_forward_train(
        params, cfg, packed, position_ids, mask, gen_mask, remat=remat, mask_meta=mask_meta,
        attn_chunk=attn_chunk, layout=layout,
        experts=ExpertParallel(mesh.group(axis), mesh.index(axis)))
