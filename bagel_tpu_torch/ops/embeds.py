"""Positional / timestep embedding tables (port of bagel_tpu/ops/embeds.py).

Frozen 2-D sin-cos grid table (upstream modeling_utils.py:24-66,127-144) and
the DiT-style sinusoidal timestep embedding (:87-105).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sincos_1d(embed_dim: int, pos: torch.Tensor) -> torch.Tensor:
    """[M] positions -> [M, embed_dim] float32 with layout [sin | cos]."""
    assert embed_dim % 2 == 0
    omega = torch.arange(embed_dim // 2, dtype=torch.float32, device=pos.device)
    omega = 1.0 / (10000.0 ** (omega / (embed_dim / 2.0)))
    out = pos.reshape(-1).float()[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def sincos_2d_grid(embed_dim: int, grid_size: int, device=None) -> torch.Tensor:
    """[grid_size**2, embed_dim] frozen table, row-major over (h, w).

    The first half of the channels encodes the column coordinate and the
    second half the row (upstream np.meshgrid(w, h) layout: [cols | rows]).
    """
    coords = torch.arange(grid_size, dtype=torch.float32, device=device)
    grid_w = coords[None, :].expand(grid_size, grid_size)  # col ids
    grid_h = coords[:, None].expand(grid_size, grid_size)  # row ids
    emb_w = sincos_1d(embed_dim // 2, grid_w.reshape(-1))
    emb_h = sincos_1d(embed_dim // 2, grid_h.reshape(-1))
    return torch.cat([emb_w, emb_h], dim=1)


def timestep_embedding(
    t: torch.Tensor, dim: int, max_period: float = 10000.0
) -> torch.Tensor:
    """[N] (fractional) timesteps -> [N, dim], layout [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(0, half, dtype=torch.float32, device=t.device)
        / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def flattened_position_ids_extrapolate(
    img_h: int, img_w: int, patch_size: int, max_num_patches_per_side: int
) -> np.ndarray:
    """Grid positions flattened into a max_side**2 table (data_utils.py:53-58)."""
    num_h, num_w = img_h // patch_size, img_w // patch_size
    coords_h = np.arange(num_h, dtype=np.int32)
    coords_w = np.arange(num_w, dtype=np.int32)
    return (coords_h[:, None] * max_num_patches_per_side + coords_w).reshape(-1)


def flattened_position_ids_interpolate(
    img_h: int, img_w: int, patch_size: int, max_num_patches_per_side: int
) -> np.ndarray:
    """Bucketized fractional positions (data_utils.py:61-69)."""
    num_h, num_w = img_h // patch_size, img_w // patch_size
    boundaries = np.arange(
        1 / max_num_patches_per_side, 1.0, 1 / max_num_patches_per_side
    )
    frac_h = np.arange(0, 1 - 1e-6, 1 / num_h)
    frac_w = np.arange(0, 1 - 1e-6, 1 / num_w)
    bucket_h = np.searchsorted(boundaries, frac_h, side="right")
    bucket_w = np.searchsorted(boundaries, frac_w, side="right")
    return (
        bucket_h[:, None] * max_num_patches_per_side + bucket_w
    ).reshape(-1).astype(np.int32)
