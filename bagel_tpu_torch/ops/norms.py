"""Functional normalization ops (port of bagel_tpu/ops/norms.py).

RMSNorm computes the variance in float32 and casts back to the input dtype
*before* the weight multiply, as the upstream Qwen2 RMSNorm does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis. fp32 accumulation, output in x.dtype."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (weight * xf.to(dtype)).to(dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last axis (fp32 statistics)."""
    out = F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(), eps)
    return out.to(x.dtype)


def group_norm_nchw(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    num_groups: int = 32, eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm over an NCHW tensor in fp32 (the VAE's internal layout)."""
    out = F.group_norm(x.float(), num_groups, weight.float(), bias.float(), eps)
    return out.to(x.dtype)


def group_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    num_groups: int = 32, eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm for NHWC tensors: the JAX op's layout at the boundary."""
    out = group_norm_nchw(x.permute(0, 3, 1, 2), weight, bias, num_groups, eps)
    return out.permute(0, 2, 3, 1)
