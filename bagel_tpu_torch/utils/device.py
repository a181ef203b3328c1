"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no device and no GPU this raises rather than running on the CPU:
    the CPU is taken only when asked for (the tests pass device="cpu").
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    return torch.device("cuda")


def process_rank_world(device: torch.device) -> Tuple[int, int, bool]:
    """(rank, world size, whether this call started the group) of the
    default torch.distributed group: (0, 1, False) without one. Under
    torchrun (WORLD_SIZE > 1 in the environment) it starts the group from
    the environment's MASTER_ADDR / MASTER_PORT / RANK: nccl on CUDA, with
    each process on the card LOCAL_RANK names, gloo otherwise."""
    import os

    import torch.distributed as dist

    started = False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
        started = True
    if not dist.is_initialized():
        return 0, 1, False
    return dist.get_rank(), dist.get_world_size(), started
