"""Distributed training over torch.distributed (port of bagel_tpu/parallel):
the (dp, fsdp, tp) mesh and its sharding rules (`mesh`), GPipe pipeline
parallelism over the layer stack (`pipeline`) and MoT expert parallelism
(`expert`). Ring attention is `ops.ring`; multi-process serving
`serving.multihost`."""

from bagel_tpu_torch.parallel.mesh import (
    AXES,
    Layout,
    Mesh,
    make_mesh,
    param_pspec,
    shard_batch,
    shard_params,
)

__all__ = ["AXES", "Layout", "Mesh", "make_mesh", "param_pspec", "shard_batch", "shard_params"]
