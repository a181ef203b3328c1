"""Training step: loss, optimizer, EMA (port of bagel_tpu/train/step.py; the
reference train loop's math, train/pretrain_unified_navit.py:666-734).

Loss normalization matches the reference: per-token CE (optionally
len2weight-reweighted) and per-token MSE are summed and divided by the
token counts of the whole batch (:695-724).

Optimizer: optax's chain, written out in place over the parameter tree:
`clip_by_global_norm` (g * max_norm / |g| when |g| >= max_norm; no 1e-6 is
added to the norm as `torch.nn.utils.clip_grad_norm_` does), then Adam
(b1, b2, eps = 1e-15, no weight decay, bias-corrected moments), then the
learning-rate schedule read at the update count before the update (so with
warmup the first update has lr 0), as `optax.scale_by_learning_rate` does.
Frozen groups (and the sin-cos position tables, always) take no gradient
and hold no moments. EMA over every leaf.

Precision: parameters, gradients, Adam moments and EMA are fp32. On CUDA
the forward runs under `torch.autocast(bfloat16)`: the products multiply in
bf16 with fp32 accumulation (the TPU's default precision for the JAX
package's fp32 parameters) and the block-sparse kernel takes bf16 q/k/v;
elsewhere everything stays fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from bagel_tpu_torch.configs import BagelConfig
from bagel_tpu_torch.models.bagel import PackedTrainBatch, bagel_forward_train

# Frozen sin-cos position tables: persistent buffers in the reference
# (modeling_utils.py:127-144), regenerated from the config here; they never
# receive an optimizer update.
FROZEN_BUFFERS = ("vit_pos_embed", "latent_pos_embed")


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict  # {"count": int, "mu": tree, "nu": tree}; None leaves where frozen
    ema_params: Optional[dict]
    step: int


def tree_map(fn, *trees):
    """fn over the leaves of dict trees of the same structure (None leaves
    of the first tree stay None)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return None if first is None else fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a dict/list tree in insertion order, None leaves kept."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def make_lr_schedule(
    lr: float,
    warmup_steps: int = 2000,
    total_steps: int = 500_000,
    kind: str = "constant",
    min_lr: float = 1e-7,
) -> Callable[[int], float]:
    """count -> learning rate, in float32 with optax's operations:
    "constant" is join(linear(0 -> lr over warmup_steps), constant(lr));
    "cosine" is warmup_cosine_decay_schedule(0, lr, warmup_steps,
    total_steps, end_value=min_lr)."""
    f32 = np.float32

    def linear(init, end, steps):
        if steps <= 0:
            return lambda count: f32(init)

        def fn(count):
            c = f32(min(max(count, 0), steps))
            frac = f32(1) - c / f32(steps)
            return f32(init - end) * frac + f32(end)
        return fn

    def join(first, second, boundary):
        return lambda count: first(count) if count < boundary else second(count - boundary)

    if kind == "constant":
        return join(linear(0.0, lr, warmup_steps), lambda count: f32(lr), warmup_steps)
    if kind == "cosine":
        decay_steps = total_steps - warmup_steps
        if not decay_steps > 0:
            raise ValueError(f"cosine schedule needs total_steps > warmup_steps, got {total_steps}")
        alpha = 0.0 if lr == 0.0 else min_lr / lr

        def cosine(count):
            c = f32(min(count, decay_steps))
            cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay_steps), dtype=f32))
            return f32(lr) * (f32(1 - alpha) * cos + f32(alpha))
        return join(linear(0.0, lr, warmup_steps), cosine, warmup_steps)
    raise ValueError(kind)


def trainable_mask(params: dict, frozen=()) -> dict:
    """True/False per top-level group: False for frozen modules
    (--freeze_llm/vit/vae, pretrain_unified_navit.py:541-551) and always
    for the sin-cos tables."""
    off = set(frozen) | set(FROZEN_BUFFERS)
    return {k: k not in off for k in params}


def set_trainable(params: dict, frozen=()) -> dict:
    """requires_grad on the leaves of trainable groups, off elsewhere (the
    reference sets requires_grad=False on frozen modules). Returns params."""
    for name, on in trainable_mask(params, frozen).items():
        for t in tree_leaves(params[name]):
            if t.is_floating_point():
                t.requires_grad_(on)
    return params


class AdamClip:
    """optax.chain(clip_by_global_norm(max_grad_norm), [masked](
    scale_by_adam(b1, b2, eps), scale_by_learning_rate(schedule))), updating
    the parameters and moments in place. A moment may live on another
    device (optimizer offload: pinned host memory); each leaf's moments are
    brought to its parameter's device for the update and written back."""

    def __init__(self, schedule, beta1=0.9, beta2=0.95, eps=1e-15,
                 max_grad_norm=1.0, frozen=()):
        self.schedule = schedule
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.max_grad_norm = max_grad_norm
        self.frozen = tuple(frozen)

    def init(self, params: dict, device=None) -> dict:
        """Zero moments for the trainable groups' leaves (None elsewhere),
        on `device` (default: each parameter's)."""
        mask = trainable_mask(params, self.frozen)

        def zeros(group):
            if not mask[group]:
                return tree_map(lambda p: None, params[group])
            return tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                                  device=device or p.device,
                                                  pin_memory=_pin(device)),
                            params[group])
        return {"count": 0,
                "mu": {k: zeros(k) for k in params},
                "nu": {k: zeros(k) for k in params}}

    def update_(self, params: dict, grads: dict, opt_state: dict) -> torch.Tensor:
        """One step in place. `grads` has params' structure with None where a
        leaf has no gradient (frozen, or not reached: counted as 0). Returns
        the global norm of the raw gradients."""
        f32 = np.float32
        gs = [g for g in tree_leaves(grads) if g is not None]
        norm = torch.sqrt(sum(g.float().square().sum() for g in gs)) if gs \
            else torch.zeros(())
        clip = not bool(norm < self.max_grad_norm)
        count = opt_state["count"]
        lr = -f32(self.schedule(count))
        b1, b2 = f32(self.b1), f32(self.b2)
        bc1 = f32(1) - b1 ** f32(count + 1)
        bc2 = f32(1) - b2 ** f32(count + 1)
        with torch.no_grad():
            for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                                    tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])):
                if mu is None:
                    continue
                if g is None:
                    g = torch.zeros_like(p)
                if clip:
                    g = (g / norm) * self.max_grad_norm
                m = mu.to(p.device, non_blocking=True)
                v = nu.to(p.device, non_blocking=True)
                m.mul_(b1).add_(g * f32(1 - self.b1))
                v.mul_(b2).add_(g * g * f32(1 - self.b2))
                u = (m / bc1) / (torch.sqrt(v / bc2) + f32(self.eps))
                p.add_(u * lr)
                if m is not mu:  # offloaded: write back
                    mu.copy_(m)
                    nu.copy_(v)
        opt_state["count"] = count + 1
        return norm


def _pin(device) -> bool:
    return (device is not None and torch.device(device).type == "cpu"
            and torch.cuda.is_available())


def make_optimizer(schedule, beta1=0.9, beta2=0.95, eps=1e-15, max_grad_norm=1.0,
                   frozen=()) -> AdamClip:
    """Adam with global-norm clipping and frozen groups masked out (no
    moments, no updates)."""
    return AdamClip(schedule, beta1, beta2, eps, max_grad_norm, frozen)


def init_train_state(params: dict, tx: AdamClip, use_ema: bool = True,
                     opt_device=None, ema_device=None) -> TrainState:
    """Marks the trainable leaves (requires_grad) and makes zero moments
    and an EMA copy; `opt_device` / `ema_device` = "cpu" keeps them in
    (pinned) host memory between steps."""
    set_trainable(params, tx.frozen)
    ema = None
    if use_ema:
        ema = tree_map(lambda p: p.detach().to(ema_device or p.device, copy=True), params)
        if _pin(ema_device):
            ema = tree_map(lambda t: t.pin_memory(), ema)
    return TrainState(params=params, opt_state=tx.init(params, opt_device),
                      ema_params=ema, step=0)


def ema_update_(ema: dict, params: dict, decay: float) -> None:
    """ema = ema * decay + params * (1 - decay), every leaf, in place."""
    with torch.no_grad():
        for e, p in zip(tree_leaves(ema), tree_leaves(params)):
            if e.device == p.device:
                e.mul_(decay).add_(p.to(e.dtype) * (1 - decay))
            else:  # offloaded
                d = e.to(p.device, non_blocking=True)
                d.mul_(decay).add_(p.to(e.dtype) * (1 - decay))
                e.copy_(d)


def compute_losses(
    params: dict,
    cfg: BagelConfig,
    batch: PackedTrainBatch,  # leading batch axis on every field
    noise: torch.Tensor,  # [B, n_vae, pd]
    ce_weight: float = 0.25,
    mse_weight: float = 1.0,
    attn_chunk=None,
    context_parallel=None,
    sparse_block=None,
    pipeline_parallel=None,
    expert_parallel=None,
    remat="full",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) over the rows of a stacked batch: a loop over rows in
    place of JAX's vmap, then CE and MSE normalized by the token counts of
    all rows. On CUDA the forward runs under bf16 autocast.
    `pipeline_parallel` raises (ROADMAP A, parallelism)."""
    if pipeline_parallel is not None:
        raise NotImplementedError(
            "pipeline_parallel (GPipe over the layer stack) waits for the "
            "parallel slice of the port (ROADMAP A, parallelism)"
        )
    if context_parallel is not None and batch.position_ids.shape[0] != 1:
        raise ValueError("context_parallel needs B=1")
    dev = batch.position_ids.device
    outs = []
    with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=dev.type == "cuda"):
        for b in range(batch.position_ids.shape[0]):
            outs.append(bagel_forward_train(
                params, cfg, batch.row(b), noise[b], attn_chunk=attn_chunk,
                context_parallel=context_parallel, sparse_block=sparse_block,
                expert_parallel=expert_parallel, remat=remat))
    cat = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    ce_w = cat["ce_weight"]
    ce = (cat["ce"] * ce_w).sum() / ce_w.sum().clamp_min(1e-8)
    loss = ce_weight * ce
    metrics = {"ce": ce.detach(), "ce_tokens": (ce_w > 0).sum()}
    if "mse" in cat:
        mse_w = cat["mse_weight"]
        mse = (cat["mse"].mean(dim=-1) * mse_w).sum() / mse_w.sum().clamp_min(1e-8)
        loss = loss + mse_weight * mse
        metrics["mse"] = mse.detach()
        metrics["mse_tokens"] = (mse_w > 0).sum()
    metrics["loss"] = loss.detach()
    return loss, metrics


def grad_step(params: dict, cfg: BagelConfig, batch: PackedTrainBatch, noise, **kw):
    """(grads, metrics): compute_losses' gradient over the leaves that
    require one; grads has params' structure, None elsewhere."""
    loss, metrics = compute_losses(params, cfg, batch, noise, **kw)
    leaves = [t for t in tree_leaves(params) if t.requires_grad]
    got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    grads = tree_map(lambda t: next(got) if t.requires_grad else None, params)
    return grads, metrics


def make_train_step(
    cfg: BagelConfig,
    tx: AdamClip,
    ce_weight: float = 0.25,
    mse_weight: float = 1.0,
    ema_decay: float = 0.9999,
    frozen=(),
    remat="full",
    attn_chunk=None,
    sparse_block=None,
):
    """The train step: (state, batch, generator) -> (state, metrics), the
    state updated in place. The flow noise is drawn from `generator` (a
    torch.Generator on the batch's device), or passed as `noise` [B, n_vae,
    pd] (JAX draws it from a PRNGKey: the tests hand the port JAX's draw).
    `frozen` must be the tuple given to make_optimizer."""
    if tuple(frozen) != tx.frozen:
        raise ValueError(f"frozen {frozen} differs from the optimizer's {tx.frozen}")

    def train_step(state: TrainState, batch: PackedTrainBatch,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None):
        if noise is None:
            noise = torch.randn(batch.vae_patches.shape, generator=generator,
                                device=batch.vae_patches.device)
        grads, metrics = grad_step(state.params, cfg, batch, noise, ce_weight=ce_weight,
                                   mse_weight=mse_weight, attn_chunk=attn_chunk,
                                   sparse_block=sparse_block, remat=remat)
        metrics["grad_norm"] = tx.update_(state.params, grads, state.opt_state)
        if state.ema_params is not None:
            ema_update_(state.ema_params, state.params, ema_decay)
        state.step += 1
        return state, metrics

    return train_step
