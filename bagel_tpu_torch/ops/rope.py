"""Rotary position embeddings for the LLM (port of bagel_tpu/ops/rope.py).

- cos/sin tables are computed in float32 from integer position ids.
- `rotate_half` layout: [-x2, x1] with the split at head_dim//2 (HF style).
- q/k layout is [..., seq, heads, head_dim]; cos/sin broadcast over heads.

The 2-D axial RoPE of the SigLIP tower comes with the understanding slice.
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
