"""TaylorSeer step cache for the denoise loop (port of
bagel_tpu/inference/taylorseer.py).

Upstream (modeling/cache_utils/taylorseer.py and the hooks in
qwen2_navit.py:773-829) runs a full transformer forward on scheduled steps
and Taylor-extrapolates per-layer features in between. On a Taylor step
every layer's output is replaced by its own extrapolation, so only the
final feature reaches the result: the cache holds Taylor factors of each
CFG branch's velocity field v_t = llm2vae(norm(h_last)) ([B, N, pd]), and a
Taylor step runs no LLM forward at all.

The schedule is numpy on the host (a copy of the JAX module's); the factor
arithmetic runs on tensors on the engine's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch


class TaylorSchedule(NamedTuple):
    is_full: np.ndarray  # [K] bool
    x_off: np.ndarray  # [K] float: step - last_full_step (Taylor steps)
    delta: np.ndarray  # [K] float: distance between the last two full steps
    grow: np.ndarray  # [K] bool: whether factor order may grow this step


def taylorseer_schedule(
    num_steps: int, fresh_threshold: int = 3, first_enhance: int = 5
) -> TaylorSchedule:
    """Upstream cal_type (taylorseer.py:79-114): the first `first_enhance`
    steps are full, then every `fresh_threshold`-th step."""
    is_full = np.zeros(num_steps, bool)
    x_off = np.zeros(num_steps, np.float32)
    delta = np.ones(num_steps, np.float32)
    grow = np.zeros(num_steps, bool)
    counter = 0
    last_full = 0
    prev_full = 0
    for k in range(num_steps):
        first = k < first_enhance
        if first or counter == fresh_threshold - 1:
            is_full[k] = True
            counter = 0
            prev_full, last_full = last_full, k
            delta[k] = max(1.0, last_full - prev_full)
            grow[k] = k > first_enhance - 2
        else:
            counter += 1
            x_off[k] = k - last_full
    return TaylorSchedule(is_full, x_off, delta, grow)


def _bmask(cond: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a scalar or per-branch [B] bool against `like` [B, ...]."""
    if cond.ndim == 0:
        return cond
    return cond.reshape(cond.shape + (1,) * (like.ndim - cond.ndim))


Scalar = Union[float, bool, torch.Tensor]


def taylor_update(
    factors: torch.Tensor,  # [O+1, ...] stacked derivative factors
    n_valid: torch.Tensor,  # [] or [B] int32: number of valid factors
    feature: torch.Tensor,  # the new observation, shaped like factors[0]
    delta: Scalar,  # step distance since the previous full step
    grow: Scalar,  # whether the order may grow
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finite-difference derivative stack (upstream
    derivative_approximation). With factors [O+1, B, ...], n_valid [B]
    counts each CFG branch's valid factors on its own: a branch that joins
    mid-run grows its order from 0."""
    max_order = factors.shape[0] - 1
    dev = factors.device
    delta = torch.as_tensor(delta, dtype=factors.dtype, device=dev)
    grow = torch.as_tensor(grow, dtype=torch.bool, device=dev)
    new = [feature]
    for i in range(max_order):
        fd = (new[i] - factors[i]) / delta
        valid = _bmask(grow & (i < n_valid), fd)
        new.append(torch.where(valid, fd, torch.zeros_like(fd)))
    new_n = torch.where(grow, torch.clamp(n_valid + 1, max=max_order + 1),
                        torch.ones_like(n_valid))
    return torch.stack(new), new_n


def taylor_eval(factors: torch.Tensor, n_valid: torch.Tensor,
                x: Scalar) -> torch.Tensor:
    """sum_i factors[i] x^i / i! over the valid factors (upstream
    taylor_formula)."""
    x = torch.as_tensor(x, dtype=factors.dtype, device=factors.device)
    out = torch.zeros_like(factors[0])
    for i in range(factors.shape[0]):
        term = factors[i] * (x**i / math.factorial(i))
        out = out + torch.where(_bmask(i < n_valid, term), term, torch.zeros_like(term))
    return out
