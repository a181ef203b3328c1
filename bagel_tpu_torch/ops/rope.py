"""Rotary position embeddings (port of bagel_tpu/ops/rope.py).

1-D RoPE for the LLM and 2-D axial RoPE for the SigLIP tower.

- cos/sin tables are computed in float32 from integer position ids.
- `rotate_half` layout: [-x2, x1] with the split at head_dim//2 (HF style).
- q/k layout is [..., seq, heads, head_dim]; cos/sin broadcast over heads.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_inv_freq(dim: int, theta: float, device=None) -> torch.Tensor:
    """inv_freq[i] = theta^(-2i/dim), i in [0, dim/2)."""
    exponents = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta**exponents)


def rope_cos_sin(
    position_ids: torch.Tensor, dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of shape position_ids.shape + (dim,), float32, with the
    frequencies duplicated [f, f] along the last axis."""
    inv_freq = rope_inv_freq(dim, theta, position_ids.device)
    freqs = position_ids.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q [..., S, H, D] and k [..., S, KH, D] by cos/sin [..., S, D]
    (broadcast over heads), in float32, cast back to each input's dtype."""
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]

    def rot(x):
        xf = x.float()
        return (xf * cos + rotate_half(xf) * sin).to(x.dtype)

    return rot(q), rot(k)


# ---------------------------------------------------------------------------
# 2-D axial RoPE for the ViT
# ---------------------------------------------------------------------------


def rope_2d_tables(
    dim_half: int, max_h: int, max_w: int, theta: float = 10000.0, device=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cos_h, sin_h, cos_w, sin_w), each [max_h*max_w, dim_half] float32.

    `dim_half` is head_dim//2: the first half of each head rotates by the
    row coordinate, the second half by the column coordinate. Row-major
    flattening: table[r * max_w + c]."""
    inv_freq = rope_inv_freq(dim_half, theta, device)  # [dim_half/2]
    rows = torch.arange(max_h, dtype=torch.float32, device=device)[:, None].expand(max_h, max_w)
    cols = torch.arange(max_w, dtype=torch.float32, device=device)[None, :].expand(max_h, max_w)

    def one_side(grid):
        freqs = grid[..., None] * inv_freq  # [H, W, dim_half/2]
        emb = torch.cat([freqs, freqs], dim=-1).reshape(-1, dim_half)
        return torch.cos(emb), torch.sin(emb)

    cos_h, sin_h = one_side(rows)
    cos_w, sin_w = one_side(cols)
    return cos_h, sin_h, cos_w, sin_w


def apply_rope_2d(q, k, cos_h, sin_h, cos_w, sin_w):
    """2-D axial rope on q/k [S, H, D]; the tables are [S, D/2], gathered at
    each token's flattened grid position. The first D/2 channels rotate with
    the row tables, the last D/2 with the column tables, in float32; the
    results are cast back to each input's dtype."""
    half = q.shape[-1] // 2

    def rot(x, cos, sin):
        xf = x.float()
        return xf * cos[:, None, :] + rotate_half(xf) * sin[:, None, :]

    def both(x):
        return torch.cat([rot(x[..., :half], cos_h, sin_h),
                          rot(x[..., half:], cos_w, sin_w)], dim=-1).to(x.dtype)

    return both(q), both(k)
