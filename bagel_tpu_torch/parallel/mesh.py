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

Inference (`InferenceLayout`): the engine's weights and KV cache by the
same table, with no autograd: Megatron tp over the LLM layers (local heads
and FFN columns, one all-reduce after o and one after down), the
embedding and the head vocab-parallel over tp, every other leaf's shards
gathered at use (the fsdp shards of a layer inside that layer, the ViT and
the adapters whole, computed replicated), each collective a plain
`torch.distributed` call on the current stream, so that a CUDA graph can
capture it. Its restrictions are where Megatron differs from GSPMD:
tp divides the query heads and the FFN width; where tp exceeds the KV
heads (tp a multiple of them) each rank keeps the one KV head its query
heads read, so the KV heads are replicated (JAX's cache rule shards KV
heads only where tp divides them); a 4-bit leaf split along its input
rows splits on its scale groups. Any other shape raises a ValueError that
names the axis.

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

import collections
import dataclasses
import itertools
import math
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bagel_tpu_torch.utils.quant import is_kmajor

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


def _split(full: torch.Tensor, dim: int, n: int, i: int, sections=None,
           where: str = "a leaf") -> torch.Tensor:
    """Shard i of n of `full` along dim: a contiguous chunk or, with
    `sections` (sizes along dim, or (size, units) pairs), chunk i of each
    section, concatenated; a section of fewer units than n (KV heads under
    tp above them, at inference) gives each unit to n // units ranks in
    turn."""
    if sections is None:
        sections = (full.shape[dim],)
    sections = [s if isinstance(s, tuple) else (s, n) for s in sections]
    parts = []
    for piece, (size, units) in zip(full.split([s for s, _ in sections], dim), sections):
        k = min(units, n)
        if size % k or (units % n if units >= n else n % units):
            raise ValueError(f"{where}: dim {dim} of size {size} ({units} units) does not "
                             f"split over {n} processes")
        parts.append(piece.chunk(k, dim)[i * k // n])
    return torch.cat(parts, dim) if len(parts) > 1 else parts[0].contiguous()


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


# ---------------------------------------------------------------------------
# Inference: the engine's weights and KV cache over the mesh
# ---------------------------------------------------------------------------

_QUANT_W = ("w_q8", "w_q", "w_p4", "w_nf4")  # utils.quant's weight codes: the "w" rule
_GROUPED = ("scale4", "absmax")  # [.., K / GROUP, N]: the weight's rule, K split on groups
_VOCAB = r"^llm/(embed|lm_head)(/|$)"  # vocab-parallel over tp


def inference_pspec(s: str, ndim: int) -> tuple:
    """`param_pspec`'s spec of a leaf of the engine's tree, quantized leaves
    (`utils.quant`) included: the codes and the group scales take their
    weight's rule, a per-column `scale` the rule without the input dim, the
    embedding's per-row `row_scale` the rule without the last dim."""
    parent, _, key = s.rpartition("/")
    if key in _QUANT_W + _GROUPED:
        return _spec(parent + "/w", ndim)
    if key in ("scale", "row_scale"):
        w = _spec(parent + "/w", ndim + 1)
        w = w + (None,) * (ndim + 1 - len(w))
        return w[:-2] + w[-1:] if key == "scale" else w[:-1]
    return _spec(s, ndim)


# the inference collectives issued, by (kind, "captured" | "eager"): a call
# under CUDA-graph capture is recorded into the graph, whose replays run it
collectives: collections.Counter = collections.Counter()


def _issued(kind: str, x: torch.Tensor) -> None:
    captured = x.is_cuda and torch.cuda.is_current_stream_capturing()
    collectives[(kind, "captured" if captured else "eager")] += 1


def gather_plain(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of x concatenated along dim, with no autograd. A
    k-major int8 weight (`utils.quant.is_kmajor`) stays k-major. A CUDA
    tensor under a backend other than nccl (gloo's all_gather takes host
    tensors) goes through host memory."""
    if group is None:
        return x
    dim %= x.ndim
    if x.dtype == torch.int8 and x.ndim >= 2 and dim >= x.ndim - 2 and is_kmajor(x):
        return gather_plain(x.mT, 2 * x.ndim - 3 - dim, group).mT
    src = x.contiguous()
    stage = src.is_cuda and dist.get_backend(group) != "nccl"
    if stage:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    _issued("all_gather", x)
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.to(x.device) if stage else out


def _all_reduce_plain(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or `op`) over the group, in place on x, with no autograd."""
    if group is not None:
        _issued("all_reduce", x)
        dist.all_reduce(x, op=op, group=group)
    return x


@dataclasses.dataclass(frozen=True)
class InferenceTP:
    """Megatron over one LLM layer at inference: the group (None: no
    collective) of n processes, this rank's query and KV heads, the
    column-parallel leaves' whole output widths (B4's rule reads the whole
    leaf, as JAX's does), and `leave`, the in-place all-reduce of the o and
    down products' partial sums: fp32 where n > 1, rounded once after the
    sum as JAX rounds the whole product; at n = 1 the whole product,
    rounded as unsharded. `row_max`: the in-place all-reduce with MAX of a
    w8a8 row-parallel leaf's activation row absmax (its input rows are
    split over tp, and JAX's scale is the whole row's)."""

    group: object
    n: int
    heads: int
    kv_heads: int
    widths: Dict[str, int]

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        return _all_reduce_plain(x, self.group)

    def row_max(self, amax: torch.Tensor) -> torch.Tensor:
        return _all_reduce_plain(amax, self.group, dist.ReduceOp.MAX)


class InferenceLayout:
    """The engine's weights and KV cache on a (dp, fsdp, tp) mesh (module
    docstring): `place` takes a whole leaf to this process's shard,
    `gather` a shard to the leaf the forward reads (no gather over tp for
    the Megatron leaves and the vocab-parallel embedding and head), `tp`
    the layers' Megatron pair, `vocab_ids` / `vocab_sum` / `vocab_gather`
    the vocab-parallel embedding and logits, `kv_heads` and `slot_rows`
    the slot cache's local part.

    The collectives of tp and dp run on every process group they have:
    at world 1 under an initialized process group that is the world
    group of one process (the all-reduces, the logits' and the tokens'
    gathers launch as at tp = 2, the smoke's check of them inside CUDA
    graphs on one card); a weight's gather over an axis of one process
    is the weight itself. Every process of a tp and fsdp group runs the
    same calls in the same order (the collectives' lockstep); dp
    coordinates differ only in the serving runtime's slot rows."""

    def __init__(self, mesh: Mesh, cfg):
        if tuple(mesh.axes) != AXES:
            raise ValueError(f"sharded inference takes a {AXES} mesh, got {mesh.axes}")
        self.mesh, self.cfg = mesh, cfg
        llm = cfg.llm
        self.tp_n = tp = mesh.shape["tp"]
        h, kh, f = llm.num_attention_heads, llm.num_key_value_heads, llm.intermediate_size
        for what, n in (("query heads", h), ("FFN columns", f)):
            if n % tp:
                raise ValueError(f"axis tp = {tp} does not divide the LLM's {n} {what}")
        if kh % tp and tp % kh:
            raise ValueError(f"axis tp = {tp} neither divides the LLM's {kh} KV heads nor is a "
                             f"multiple of them")
        self.heads = h // tp
        self.kv_heads = max(kh // tp, 1)  # tp > KV heads: the one its query heads read
        hd = llm.head_dim
        self.tp = InferenceTP(self.group("tp"), tp, self.heads, self.kv_heads, dict(
            qkv=(h + 2 * kh) * hd, q=h * hd, k=kh * hd, v=kh * hd, gate_up=2 * f, gate=f, up=f))

    def group(self, *axes: str):
        """The mesh's group of `axes`, or at world 1 under a process group
        the world group (class docstring); None: no collective."""
        g = self.mesh.group(*axes)
        if g is None and self.mesh.world == 1 and dist.is_available() and dist.is_initialized():
            return dist.group.WORLD
        return g

    def _sections(self, s: str, ndim: int, dim: int):
        """The tp split of a fused or per-head LLM leaf's output dim: (size,
        units) sections, each split by its units (heads, FFN columns)."""
        if dim != ndim - 1 or not s.startswith("llm/layers/"):
            return None
        llm, t = self.cfg.llm, s + "/"
        hd, h, kh = llm.head_dim, llm.num_attention_heads, llm.num_key_value_heads
        if "/qkv/" in t:
            return (h * hd, h), (kh * hd, kh), (kh * hd, kh)
        if re.search(r"/attn(_gen)?/[kv]/", t):
            return ((kh * hd, kh),)
        if re.search(r"/attn(_gen)?/q/", t):
            return ((h * hd, h),)
        if "/gate_up" in t:
            f = llm.intermediate_size
            return (f, f), (f, f)
        return None

    def place(self, s: str, full: torch.Tensor) -> torch.Tensor:
        """This process's shard of the whole leaf at path `s`: a copy that
        keeps none of `full`'s memory, or `full` itself where nothing
        splits."""
        x = full
        for dim, axis in enumerate(inference_pspec(s, full.ndim)):
            if axis is None or self.mesh.shape[axis] == 1:
                continue
            sections = self._sections(s, full.ndim, dim) if axis == "tp" else None
            x = _split(x, dim, self.mesh.shape[axis], self.mesh.coord[axis], sections,
                       f"{s} over axis {axis}")
        if x is full:
            return full
        same = x.untyped_storage().data_ptr() == full.untyped_storage().data_ptr()
        return x.clone() if same else x

    def place_tree(self, tree, prefix: str = ""):
        """`place` over every leaf of a dict/list tree (paths from `prefix`)."""
        if isinstance(tree, dict):
            return {k: self.place_tree(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.place_tree(v, f"{prefix}/{i}") for i, v in enumerate(tree))
        return self.place(prefix, tree)

    def gather(self, s: str, local: torch.Tensor, layer: bool = False) -> torch.Tensor:
        """The leaf as the forward reads it: each shard gathered but tp's of
        the Megatron and vocab-parallel leaves. layer=True: `local` is one
        layer's slice of a stacked leaf."""
        local_tp = re.search(_MEGATRON, s + "/") or re.search(_VOCAB, s)
        x = local
        spec = inference_pspec(s, local.ndim + layer)
        for dim in reversed(range(len(spec))):
            axis = spec[dim]
            if axis is None or (layer and dim == 0) or (axis == "tp" and local_tp) \
                    or self.mesh.shape[axis] == 1:
                continue
            x = gather_plain(x, dim - layer, self.mesh.group(axis))
        return x

    def gather_tree(self, tree, prefix: str, layer: bool = False, skip=()):
        """`gather` over a dict/list tree; the top-level keys in `skip` stay
        as they are."""
        if isinstance(tree, dict):
            return {k: v if k in skip else self.gather_tree(v, f"{prefix}/{k}", layer)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.gather_tree(v, f"{prefix}/{i}", layer)
                              for i, v in enumerate(tree))
        return self.gather(prefix, tree, layer)

    # -- the vocab-parallel embedding and head --------------------------------

    def vocab_ids(self, ids: torch.Tensor, rows: int):
        """(local ids, hit): ids in this rank's `rows` of the vocabulary,
        others at 0, and where they were."""
        local = ids - self.mesh.coord["tp"] * rows
        hit = (local >= 0) & (local < rows)
        return torch.where(hit, local, torch.zeros_like(local)), hit

    def vocab_sum(self, rows: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
        """Embedding rows looked up on each rank's part of the vocabulary:
        the misses zeroed, each row's fsdp shards gathered, the sum over tp
        (one rank's row and zeros: exact)."""
        rows = torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))
        if self.mesh.shape["fsdp"] > 1:
            rows = gather_plain(rows, -1, self.mesh.group("fsdp"))
        return _all_reduce_plain(rows.contiguous(), self.tp.group)

    def vocab_gather(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's logits over its part of the vocabulary [..., V / tp]
        -> every rank's [..., V] (the rows all-gathered, not the head)."""
        return gather_plain(logits, -1, self.tp.group)

    # -- the slot cache -----------------------------------------------------------

    def slot_rows(self, slots: int) -> Tuple[int, int]:
        """(first, count) of the slot rows this dp coordinate holds: its
        share where dp divides the slots, else all of them."""
        n = self.mesh.shape["dp"]
        if slots % n:
            return 0, slots
        return self.mesh.coord["dp"] * (slots // n), slots // n

    def dp_group(self, slots: int):
        """The group that all-gathers the slot rows' tokens and lengths
        (None where every dp coordinate holds every row)."""
        return self.group("dp") if slots % self.mesh.shape["dp"] == 0 else None


def shard_cache(layout: InferenceLayout, cache, slots: int):
    """This process's part of a whole slot cache ([L, slots, S, KH, D] and
    its scales) by JAX's `_shard_cache` rule (bagel_tpu/serving/runtime.py:
    207-223): the slots over dp where dp divides them, the KV heads over tp
    (each rank the KV heads its query heads read)."""
    first, rows = layout.slot_rows(slots)
    tp, kh = layout.mesh.shape["tp"], cache.k.shape[3]

    def take(t):
        if t is None:
            return None
        return _split(t[:, first:first + rows], 3, tp, layout.mesh.coord["tp"], ((kh, kh),),
                      "the cache's KV heads over axis tp").contiguous()

    return dataclasses.replace(cache, k=take(cache.k), v=take(cache.v),
                               k_scale=take(cache.k_scale), v_scale=take(cache.v_scale),
                               length=cache.length[first:first + rows].clone())
