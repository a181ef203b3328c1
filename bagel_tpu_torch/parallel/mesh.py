"""Process mesh and the sharding rules of the training state over
torch.distributed (port of bagel_tpu/parallel/mesh.py).

  axes = ("dp", "fsdp", "tp")
  - dp:   data parallel: each dp coordinate takes its own rows of the batch;
          the gradients are summed over dp (the losses are normalized by the
          global token counts, `train.step.compute_losses`).
  - fsdp: parameter sharding along the input/feature dim of weights
          (ZeRO-3): each leaf is all-gathered where it is used, an LLM
          layer's leaves inside that layer's (recomputed) body, and its
          gradient is reduce-scattered.
  - tp:   Megatron tensor parallelism over the LLM layers: q/k/v and
          gate/up split by heads and FFN columns, o and down by their input
          rows, one all-reduce after o and one after down. Other leaves that
          the table shards over tp (embeddings, heads, SigLIP) are gathered
          at use, as fsdp leaves are.

`_PARAM_RULES` and `param_pspec` are JAX's table: `param_pspec` gives each
leaf the spec that `bagel_tpu.parallel.param_pspec` gives it, as a tuple of
axis names. In JAX, GSPMD derives every collective from that table
(bagel_tpu/train/step.py:5-8). Here `Layout` places each leaf's local
shard by the same table and the collectives are explicit: autograd
Functions whose backward is the transpose of their forward (all-gather and
reduce-scatter, identity and all-reduce, a ring permute and its reverse).

The state is plain local tensors, one shard a leaf, not DTensors: the
forward is the port's functions over parameter dicts, with ctypes kernels
that take plain contiguous tensors, and each collective sits at one named
point of the layer code (JAX's `train_layer_block` positions).

Fused leaves (`qkv`, `gate_up`) shard their output dim per section under
tp: rank r holds heads r of q, of k and of v (and columns r of gate and of
up), where JAX's table splits the fused dim contiguously and GSPMD keeps
the math exact.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp")

# (path regex, spec): first match wins. Paths look like "llm/layers/attn/q/w",
# "vit/layers/mlp/fc1/b", "llm/embed", ... (bagel_tpu/parallel/mesh.py:50-79)
_PARAM_RULES = [
    # LLM stacked layers: leading L axis unsharded. qkv/gate_up are the
    # fused projection leaves, output dim last, same spec as unfused.
    (r"llm/layers/attn(_gen)?/(q|k|v|qkv)/w", (None, "fsdp", "tp")),
    (r"llm/layers/attn(_gen)?/(q|k|v|qkv)/b", (None, "tp")),
    (r"llm/layers/attn(_gen)?/o/w", (None, "tp", "fsdp")),
    (r"llm/layers/mlp(_gen)?/(gate|up|gate_up)", (None, "fsdp", "tp")),
    (r"llm/layers/mlp(_gen)?/down", (None, "tp", "fsdp")),
    (r"llm/embed", ("tp", "fsdp")),
    (r"llm/lm_head/w", ("fsdp", "tp")),
    # ViT stacked layers
    (r"vit/layers/attn/(q|k|v)/w", (None, "fsdp", "tp")),
    (r"vit/layers/attn/(q|k|v)/b", (None, "tp")),
    (r"vit/layers/attn/o/w", (None, "tp", "fsdp")),
    (r"vit/layers/mlp/fc1/w", (None, "fsdp", "tp")),
    (r"vit/layers/mlp/fc1/b", (None, "tp")),
    (r"vit/layers/mlp/fc2/w", (None, "tp", "fsdp")),
    (r"vit/patch_embed/w", (None, "fsdp")),
    # adapters
    (r"connector/fc1/w", ("fsdp", "tp")),
    (r"connector/fc2/w", ("tp", "fsdp")),
    (r"time_embed/fc1/w", (None, "tp")),
    (r"time_embed/fc2/w", ("tp", "fsdp")),
    (r"vae2llm/w", (None, "fsdp")),
    (r"llm2vae/w", ("fsdp", None)),
    # everything else (norms, biases, vae convs, pos tables): replicated
]

# the LLM layer leaves that Megatron splits (local shards, no gather over tp)
_MEGATRON = r"llm/layers/(attn(_gen)?/(q|k|v|qkv|o)|mlp(_gen)?/(gate|up|gate_up|down))/"
# replicated leaves whose gradient is a partial sum over tp under Megatron:
# each rank's per-head norm weights see only its own heads
_TP_PARTIAL = r"llm/layers/attn(_gen)?/(q_norm|k_norm)$"
# (und, gen) subtree pairs of the MoT layers (bagel_tpu/parallel/expert.py:60-66)
_EXPERT_PAIRS = (("attn", "attn_gen"), ("mlp", "mlp_gen"),
                 ("input_ln", "input_ln_gen"), ("post_ln", "post_ln_gen"))


def _path_str(path) -> str:
    if isinstance(path, str):
        return path
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def param_pspec(path, leaf, pipeline_axis=None) -> tuple:
    """The spec of one leaf: a tuple with one entry a leading dim (an axis
    name or None), trailing unsharded dims omitted, as JAX's PartitionSpec.
    `path` is a '/'-joined string or a sequence of keys."""
    return _spec(_path_str(path), leaf.ndim, pipeline_axis)


def _spec(s: str, ndim: int, pipeline_axis=None) -> tuple:
    if pipeline_axis is not None:
        # pipeline parallelism: the LLM layer stacks shard their leading L
        # axis over the stage axis (contiguous L/pp chunks, the stage-major
        # [pp, L/pp, ...] layout of parallel.pipeline.stage_layers);
        # everything else replicates
        return (pipeline_axis,) if re.search(r"llm/layers/", s) else ()
    for pattern, spec in _PARAM_RULES:
        if re.search(pattern, s):
            return spec[:ndim]
    return ()


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


class Mesh:
    """The processes of the default torch.distributed group as a grid: rank
    r sits at `np.unravel_index(r, shape)`. Without a process group the mesh
    has one process and every collective is the identity.

    `device_mesh` is the torch.distributed DeviceMesh with these axis names;
    `group(*axes)` is the process group of the ranks that differ only along
    `axes` (None where that is this process alone)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str] = AXES, device_type="cpu"):
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} does not name the axes {axes}")
        on = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if on else 1
        rank = dist.get_rank() if on else 0
        if math.prod(shape) != world:
            raise ValueError(
                f"mesh {shape} needs {math.prod(shape)} processes, but the process group "
                f"has {world}: start one process per mesh entry (torchrun --nproc_per_node "
                f"{math.prod(shape)})")
        self.axes, self.world, self.rank = axes, world, rank
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.coord: Dict[str, int] = dict(zip(axes, (int(i) for i in np.unravel_index(rank, shape))))
        self.device_mesh = None
        self._groups: Dict[frozenset, Optional[object]] = {}
        if on and world > 1:
            from torch.distributed.device_mesh import init_device_mesh

            self.device_mesh = init_device_mesh(device_type, shape, mesh_dim_names=axes)
            # every subset of two or more axes: new_group is collective over
            # the world, so all processes build the same groups in one order
            grid = np.arange(world).reshape(shape)
            for n in range(2, len(axes) + 1):
                for sub in itertools.combinations(range(len(axes)), n):
                    if math.prod(shape[i] for i in sub) in (1, world):
                        continue
                    moved = np.moveaxis(grid, sub, tuple(range(-n, 0)))
                    for ranks in moved.reshape(-1, math.prod(shape[i] for i in sub)):
                        g = dist.new_group([int(r) for r in ranks])
                        if rank in ranks:
                            self._groups[frozenset(axes[i] for i in sub)] = g

    def size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, axis: str) -> int:
        return self.coord[axis]

    def group(self, *axes: str):
        axes = tuple(a for a in axes if self.shape[a] > 1)
        if not axes:
            return None
        if self.size(*axes) == self.world:
            return dist.group.WORLD
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._groups[frozenset(axes)]


def make_mesh(shape: Optional[Tuple[int, ...]] = None, axes: Sequence[str] = AXES,
              device_type: str = "cpu") -> Mesh:
    """A (dp, fsdp, tp) mesh over the processes of the default group (or
    `axes` of another name). Default: every process on fsdp."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if shape is None:
        shape = (1, world, 1)
    return Mesh(shape, axes, device_type)


# ---------------------------------------------------------------------------
# Collectives as autograd Functions
# ---------------------------------------------------------------------------


def group_size(group) -> int:
    """The number of processes of a group (None: this process alone)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This process's rank in a group (None: 0)."""
    return 0 if group is None else dist.get_rank(group)


def _split(full: torch.Tensor, dim: int, n: int, i: int, sections=None) -> torch.Tensor:
    """Shard i of n of `full` along dim: a contiguous chunk, or with
    `sections` (sizes along dim) chunk i of each section, concatenated."""
    if sections is None:
        if full.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {full.shape[dim]} does not split {n} ways")
        return full.chunk(n, dim)[i].contiguous()
    return torch.cat([_split(p, dim, n, i) for p in full.split(list(sections), dim)], dim)


def _join(parts, dim: int, sections=None) -> torch.Tensor:
    """Inverse of `_split` over its n shards in order."""
    if sections is None:
        return torch.cat(parts, dim)
    n = len(parts)
    local = [s // n for s in sections]
    pieces = [p.split(local, dim) for p in parts]
    return torch.cat([torch.cat([pc[j] for pc in pieces], dim) for j in range(len(local))], dim)


def _all_gather(x: torch.Tensor, dim: int, group, sections=None) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return _join(parts, dim, sections)


def _reduce_scatter(x: torch.Tensor, dim: int, group, sections=None) -> torch.Tensor:
    """This rank's shard (as `_split`) of the sum of x over the group."""
    n, i = group_size(group), group_rank(group)
    if n == 1:
        return x
    if dist.get_backend(group) == "nccl":
        major = torch.cat([_split(x, dim, n, r, sections).movedim(dim, 0) for r in range(n)], 0)
        out = major.new_empty((major.shape[0] // n,) + major.shape[1:])
        dist.reduce_scatter_tensor(out, major.contiguous(), group=group)
        return out.movedim(0, dim).contiguous()
    y = x.contiguous().clone()  # gloo has no reduce-scatter
    dist.all_reduce(y, group=group)
    return _split(y, dim, n, i, sections)


class _GatherParam(torch.autograd.Function):
    """A leaf's shard gathered at use: all-gather forward; reduce-scatter of
    the gradient, divided by the group size (the ranks of the group ran the
    same rows, so each holds the whole gradient of the gathered leaf)."""

    @staticmethod
    def forward(ctx, x, dim, group, sections):
        ctx.dim, ctx.group, ctx.sections = dim, group, sections
        return _all_gather(x, dim, group, sections)

    @staticmethod
    def backward(ctx, g):
        n = group_size(ctx.group)
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.sections) / n, None, None, None


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient (a
    replicated tensor entering a computation that each rank does on its own
    part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: all-reduce forward (the sum of the ranks' partial
    results, replicated after it), identity backward (every rank holds the
    whole gradient of the replicated sum)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitSeq(torch.autograd.Function):
    """A replicated tensor's own chunk along dim; the gradient is gathered
    (each rank's part of the replicated tensor's gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _split(x, dim, group_size(group), group_rank(group))

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _GatherSeq(torch.autograd.Function):
    """The chunks of the group concatenated along dim (replicated after
    it); the gradient is this rank's chunk of the replicated gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.dim, group_size(ctx.group), group_rank(ctx.group)), None, None


def permute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """x of group rank i arrives at rank i + shift (mod n); returns what
    rank i - shift sent. One batch of isend/irecv (a ring of blocking sends
    would deadlock). No autograd."""
    n, i = group_size(group), group_rank(group)
    if n == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    to = dist.get_global_rank(group, (i + shift) % n)
    frm = dist.get_global_rank(group, (i - shift) % n)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to, group),
                                   dist.P2POp(dist.irecv, out, frm, group)])
    for r in reqs:
        r.wait()
    return out


class _RingPermute(torch.autograd.Function):
    """`lax.ppermute` over the ring i -> i + 1; its backward is the reverse
    rotation (the transpose XLA derives in JAX)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return permute(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return permute(g, ctx.group, -1), None


def ring_permute(x: torch.Tensor, group) -> torch.Tensor:
    """Send x to the next rank of the group's ring, return the previous
    rank's (differentiable)."""
    return x if group_size(group) == 1 else _RingPermute.apply(x, group)


def copy_to_group(x, group):
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return x if group_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def split_seq(x, dim, group):
    return x if group_size(group) == 1 else _SplitSeq.apply(x, dim, group)


def gather_seq(x, dim, group):
    return x if group_size(group) == 1 else _GatherSeq.apply(x, dim, group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over the group (no autograd)."""
    if group_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


# ---------------------------------------------------------------------------
# Where each leaf lives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """One leaf's place on the mesh.

    shards: ((dim, axis, sections), ...) the dims split over mesh axes;
    local: the axes whose shards the forward uses as they are (Megatron's
    tp, the pipeline's stage axis), every other shard is gathered at use;
    owner: (axis, index) where only that coordinate holds the leaf (an
    expert under expert parallelism; the others hold an empty tensor);
    partial: axes over which each rank's gradient is a partial sum."""

    shards: tuple = ()
    local: frozenset = frozenset()
    owner: Optional[tuple] = None
    partial: frozenset = frozenset()


def _gather(x, dim, group, sections):
    if x.requires_grad:
        return _GatherParam.apply(x, dim, group, sections)
    return _all_gather(x, dim, group, sections)


class Layout:
    """The training state's layout on `mesh`, from `param_pspec`'s table.

    mode: `pipeline_axis` (JAX's pipeline branch: LLM layers split over the
    stage axis, everything else replicated), `expert_axis` (that axis drops
    out of the table and holds the MoT expert pairs: coordinate e holds
    entry e of `parallel.expert.split_expert_layers`' [2, L, ...] stack),
    `context_axis` (the ring's axis; it keeps its rules, and is not
    Megatron's). Megatron tp runs when tp > 1 and no mode claims tp.

    The expert pairs come from the config. `bind(params)` reads the full
    tree's leaf shapes, or `shard` records each leaf's shape as it comes (`models.bagel.
    init_bagel_params(place=layout.shard)`); every other method takes a
    leaf's '/'-joined path."""

    def __init__(self, mesh: Mesh, cfg, pipeline_axis=None, expert_axis=None,
                 context_axis=None):
        self.mesh, self.cfg = mesh, cfg
        self.pipeline_axis, self.expert_axis = pipeline_axis, expert_axis
        self.context_axis = context_axis
        llm = cfg.llm
        claimed = {pipeline_axis, expert_axis, context_axis}
        self.tp = mesh.shape.get("tp", 1) if not claimed & {"tp"} and pipeline_axis is None else 1
        if self.tp > 1:
            bad = [(name, n) for name, n in (("heads", llm.num_attention_heads),
                                             ("KV heads", llm.num_key_value_heads),
                                             ("FFN columns", llm.intermediate_size))
                   if n % self.tp]
            if bad:
                raise ValueError(f"tp = {self.tp} does not divide the LLM's {bad}")
            if expert_axis is not None:
                raise ValueError("expert parallelism composes with tp only on the tp axis "
                                 "itself (--expert_parallel tp)")
        if expert_axis is not None and mesh.shape[expert_axis] != 2:
            raise ValueError(f"expert_parallel needs axis '{expert_axis}' of size 2 (und/gen), "
                             f"got {mesh.shape[expert_axis]}")
        if pipeline_axis is not None and mesh.shape.get("dp", 1) != 1:
            raise ValueError("pipeline parallelism needs mesh dp = 1")
        self.shapes: Dict[str, tuple] = {}
        mot = llm.layer_module == "mot"
        pairs = {"attn": mot, "mlp": llm.use_moe, "input_ln": mot, "post_ln": mot}
        self._experts: Dict[str, int] = {k: e for und, gen in _EXPERT_PAIRS if pairs.get(und)
                                         for k, e in ((und, 0), (gen, 1))}
        self._cache: Dict[str, Placement] = {}

    def bind(self, params: dict) -> "Layout":
        """Record the full tree's leaf shapes."""
        self.shapes = {p: tuple(t.shape) for p, t in leaf_paths(params) if t is not None}
        self._cache = {}
        return self

    def _sections(self, s: str) -> Optional[tuple]:
        llm = self.cfg.llm
        if re.search(r"/qkv/(w|b)$", s):
            hd = llm.head_dim
            return (llm.num_attention_heads * hd, llm.num_key_value_heads * hd,
                    llm.num_key_value_heads * hd)
        if re.search(r"/gate_up$", s):
            return (self.shapes[s][-1] // 2,) * 2
        return None

    def placement(self, s: str) -> Placement:
        if s in self._cache:
            return self._cache[s]
        spec = _spec(s, len(self.shapes[s]), self.pipeline_axis)
        owner = None
        if self.expert_axis is not None:
            spec = tuple(None if a == self.expert_axis else a for a in spec)
            m = re.match(r"llm/layers/([^/]+)", s)
            if m and m.group(1) in self._experts:
                owner = (self.expert_axis, self._experts[m.group(1)])
        shards = tuple((d, a, self._sections(s) if a == "tp" else None)
                       for d, a in enumerate(spec)
                       if a is not None and self.mesh.shape.get(a, 1) > 1)
        local = set()
        if self.pipeline_axis is not None:
            local.add(self.pipeline_axis)
        if self.tp > 1 and re.search(_MEGATRON, s + "/"):
            local.add("tp")
        partial = frozenset({"tp"}) if self.tp > 1 and re.search(_TP_PARTIAL, s) else frozenset()
        p = self._cache[s] = Placement(shards, frozenset(local), owner, partial)
        return p

    def holds(self, s: str) -> bool:
        owner = self.placement(s).owner
        return owner is None or self.mesh.index(owner[0]) == owner[1]

    # -- state ----------------------------------------------------------------

    def shard(self, s: str, full: torch.Tensor) -> torch.Tensor:
        """This process's shard of a full leaf (a copy, which keeps none of
        `full`'s memory; the leaf's shape is recorded)."""
        self.shapes.setdefault(s, tuple(full.shape))
        if not self.holds(s):
            return full.new_empty((0,))
        x = full
        for dim, axis, sections in self.placement(s).shards:
            x = _split(x, dim, self.mesh.size(axis), self.mesh.index(axis), sections)
        same = x.untyped_storage().data_ptr() == full.untyped_storage().data_ptr()
        return x.clone() if same else x

    def unshard(self, s: str, local: torch.Tensor) -> torch.Tensor:
        """The full leaf on every process (collective, no autograd)."""
        p = self.placement(s)
        x = local.detach()
        if self.holds(s):
            for dim, axis, sections in reversed(p.shards):
                x = _all_gather(x, dim, self.mesh.group(axis), sections)
        if p.owner is not None:
            axis, idx = p.owner
            x = x.contiguous() if self.holds(s) else local.new_empty(self.shapes[s])
            group = self.mesh.group(axis)
            dist.broadcast(x, dist.get_global_rank(group, idx), group=group)
        return x

    def gather(self, s: str, local: torch.Tensor, layer: bool = False) -> torch.Tensor:
        """A leaf as the forward uses it: every shard of a dim that is not
        the local axes' gathered, differentiably. layer=True: `local` is
        one layer's slice of a stacked leaf (its dims shift by one)."""
        x = local
        if not self.holds(s):
            return x
        p = self.placement(s)
        for dim, axis, sections in reversed(p.shards):
            if axis in p.local or (layer and dim == 0):
                continue
            x = _gather(x, dim - layer, self.mesh.group(axis), sections)
        return x

    def gather_tree(self, tree, prefix: str = "", skip=(), layer: bool = False):
        """`gather` over a dict/list tree; paths in `skip` (and below) stay
        as they are."""
        if prefix in skip:
            return tree
        if isinstance(tree, dict):
            return {k: self.gather_tree(v, f"{prefix}/{k}" if prefix else str(k), skip, layer)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.gather_tree(v, f"{prefix}/{i}", skip, layer)
                              for i, v in enumerate(tree))
        return self.gather(prefix, tree, layer)

    # -- gradients --------------------------------------------------------------

    def _replicated(self, s: str) -> list:
        """The non-dp axes along which the leaf is replicated."""
        p = self.placement(s)
        taken = {a for _, a, _ in p.shards} | set(p.partial)
        if p.owner:
            taken.add(p.owner[0])
        return [a for a in self.mesh.axes
                if a != "dp" and self.mesh.shape[a] > 1 and a not in taken]

    def reduce_grads_(self, leaves: list, grads: list) -> None:
        """In place over `grads` (one per (path, local leaf) of `leaves`;
        None where a leaf took no gradient becomes 0): the sum over dp
        and over the partial axes, the mean over the axes the leaf is
        replicated along. After it every process holding a copy of a shard
        holds the same gradient."""
        dp = ["dp"] if self.mesh.shape.get("dp", 1) > 1 else []
        for j, ((s, local), g) in enumerate(zip(leaves, grads)):
            g = grads[j] = torch.zeros_like(local) if g is None else g.contiguous()
            rep = self._replicated(s)
            group = self.mesh.group(*dp, *self.placement(s).partial, *rep)
            if group is None:
                continue
            dist.all_reduce(g, group=group)
            n = self.mesh.size(*rep)
            grads[j] = g / n if n > 1 else g

    def counts_once(self, s: str) -> bool:
        """Whether this process counts the leaf's shard in a global sum: the
        one copy at coordinate 0 of every axis it is replicated along (and
        of dp and the partial axes, after `reduce_grads_`)."""
        axes = self._replicated(s) + list(self.placement(s).partial) + \
            ["dp"] * ("dp" in self.mesh.shape)
        return self.holds(s) and all(self.mesh.index(a) == 0 for a in axes)

    def sum_over_world(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_(x, self.mesh.group(*self.mesh.axes))

    def sum_over_dp(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_(x, self.mesh.group("dp") if "dp" in self.mesh.shape else None)

    def tensor_parallel(self) -> Optional["TensorParallel"]:
        return TensorParallel(self.mesh.group("tp"), self.tp) if self.tp > 1 else None


@dataclasses.dataclass
class TensorParallel:
    """Megatron's pair over the tp group of size n: `enter` (f: identity,
    the gradient all-reduced) before the column-parallel products, `leave`
    (g: the partial sums all-reduced, identity backward) after the
    row-parallel ones."""

    group: object
    n: int

    def enter(self, x):
        return copy_to_group(x, self.group)

    def leave(self, x):
        return reduce_from_group(x, self.group)


def leaf_paths(tree, prefix: str = "") -> list:
    """[('/'-joined path, leaf)] of a dict/list tree in order, None leaves
    kept (list items keyed by index, as the checkpoint's paths)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(leaf_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def shard_params(layout: Layout, params: dict) -> dict:
    """The tree of this process's shards of a full tree (`layout.bind`s to
    it). The full leaves are not kept."""
    layout.bind(params)

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{prefix}/{i}") for i, v in enumerate(node))
        return layout.shard(prefix, node)

    return walk(params, "")


def shard_batch(mesh: Mesh, batch):
    """This dp coordinate's rows of a stacked batch (`models.bagel.
    PackedTrainBatch` or a tensor with a leading row axis)."""
    n, i = mesh.shape.get("dp", 1), mesh.coord.get("dp", 0)
    if n == 1:
        return batch

    def rows(x):
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over dp = {n}")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    return batch.map(rows) if hasattr(batch, "map") else rows(batch)
