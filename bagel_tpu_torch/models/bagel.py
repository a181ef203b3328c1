"""Bagel generation-side assembly (port of bagel_tpu/models/bagel.py).

Adapters and helpers of the text-to-image path: the timestep embedder, the
latent <-> LLM projections, latent patchify, the shifted denoise schedule
and classifier-free-guidance combination. The ViT connector, the packed
training forward and `visual_und=True` params come with later slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bagel_tpu_torch.configs import BagelConfig
from bagel_tpu_torch.models import qwen2
from bagel_tpu_torch.models.vae import init_vae_params
from bagel_tpu_torch.ops.embeds import sincos_2d_grid, timestep_embedding
from bagel_tpu_torch.utils.device import resolve_device


def _dense_init(generator, d_in, d_out, dtype, device, std=0.02, zero=False):
    if zero:
        w = torch.zeros((d_in, d_out), dtype=torch.float32, device=device)
    else:
        w = torch.randn((d_in, d_out), generator=generator,
                        dtype=torch.float32, device=device) * std
    return {"w": w.to(dtype), "b": torch.zeros((d_out,), dtype=dtype, device=device)}


def _linear(x, p):
    """x @ w + b computed in the promoted dtype of x and w (as jnp.dot
    promotes), returned in x.dtype."""
    ct = torch.promote_types(x.dtype, p["w"].dtype)
    out = torch.matmul(x.to(ct), p["w"].to(ct)) + p["b"].to(ct)
    return out.to(x.dtype)


def init_bagel_params(
    generator: torch.Generator, cfg: BagelConfig, dtype=torch.bfloat16,
    device=None,
) -> dict:
    """Parameter tree: llm / vae / generation adapters, in the JAX layout.

    llm2vae starts at zero (upstream _init_weights). `generator` must live
    on `device`.
    """
    if cfg.visual_und:
        raise NotImplementedError(
            "visual_und=True needs SigLIP, which comes with the understanding "
            "slice; pass a config with visual_und=False"
        )
    device = resolve_device(device)
    d = cfg.llm.hidden_size
    g, dev = generator, device
    params = {"llm": qwen2.init_qwen2_params(g, cfg.llm, dtype, dev)}
    if cfg.visual_gen:
        params["vae"] = init_vae_params(g, cfg.vae, torch.float32, dev)
        pd = cfg.patch_latent_dim
        params["time_embed"] = {
            "fc1": _dense_init(g, 256, d, dtype, dev),
            "fc2": _dense_init(g, d, d, dtype, dev),
        }
        params["vae2llm"] = _dense_init(g, pd, d, dtype, dev)
        params["llm2vae"] = _dense_init(g, d, pd, dtype, dev, zero=True)
        params["latent_pos_embed"] = sincos_2d_grid(
            d, cfg.max_latent_size, device=dev
        ).to(dtype)
    return params


def time_embed(params, t):
    """Scalar timesteps [N] -> [N, d] (upstream TimestepEmbedder)."""
    freq = timestep_embedding(t, 256)
    h = _linear(freq, params["time_embed"]["fc1"])
    return _linear(F.silu(h), params["time_embed"]["fc2"])


def latent_to_llm(params, cfg: BagelConfig, x_t, t, latent_pos_ids):
    """VAE latent patches [N, pd] + timesteps [N] -> LLM-space embeddings:
    vae2llm(x) + time_embed(t) + latent_pos_embed."""
    h = _linear(x_t, params["vae2llm"])
    h = h + time_embed(params, t).to(h.dtype)
    return h + params["latent_pos_embed"][latent_pos_ids].to(h.dtype)


def patchify_latent(z: torch.Tensor, p: int) -> torch.Tensor:
    """[h*p, w*p, C] latent grid -> [h*w, p*p*C] patch rows, per-patch
    layout (p, q, c)."""
    hp, wp, c = z.shape
    h, w = hp // p, wp // p
    z = z.reshape(h, p, w, p, c).permute(0, 2, 1, 3, 4)
    return z.reshape(h * w, p * p * c)


def unpatchify_latent(x: torch.Tensor, h: int, w: int, p: int, c: int) -> torch.Tensor:
    """[h*w, p*p*C] -> [h*p, w*p, C]."""
    z = x.reshape(h, w, p, p, c).permute(0, 2, 1, 3, 4)
    return z.reshape(h * p, w * p, c)


def shifted_timesteps(num_timesteps: int, shift: float) -> Tuple[np.ndarray, np.ndarray]:
    """Denoise schedule on the host, in float32: t_i over linspace(1, 0)
    with the timestep shift t' = s*t / (1 + (s-1) t); returns (timesteps
    [T-1], dts [T-1]).

    Each float32 operation is the one the JAX engine's compiled schedule
    performs (its linspace is 1 - i * (1/(n-1)) with an exact 0 appended;
    `shift - 1` is rounded from a Python float), so the values, and the
    cfg_interval phase split taken from them, match it bit for bit."""
    f32 = np.float32
    n = num_timesteps
    if n > 1:
        i = np.arange(n - 1, dtype=f32)
        t = np.append(f32(1.0) - i * (f32(1.0) / f32(n - 1)), f32(0.0))
    else:
        t = np.ones(n, f32)
    t = f32(shift) * t / (f32(1.0) + f32(shift - 1.0) * t)
    return t[:-1], t[:-1] - t[1:]


def cfg_combine(
    v_cond: torch.Tensor,  # [N, pd]
    v_text: Optional[torch.Tensor],
    v_img: Optional[torch.Tensor],
    cfg_text_scale: float,
    cfg_img_scale: float,
    cfg_renorm_type: str = "global",
    cfg_renorm_min: float = 0.0,
) -> torch.Tensor:
    """Dual classifier-free guidance with renormalization (upstream
    bagel.py:873-902). Renorm types: "global" (one 2-norm over all elements),
    "channel" (per-token norm), "text_channel" (renorm the text-CFG result
    per token before applying image CFG)."""
    if v_text is None or cfg_text_scale <= 1.0:
        return v_cond

    def renorm(v_ref, v_new, per_token: bool):
        if per_token:
            n_ref = torch.linalg.vector_norm(v_ref, dim=-1, keepdim=True)
            n_new = torch.linalg.vector_norm(v_new, dim=-1, keepdim=True)
        else:
            n_ref = torch.linalg.vector_norm(v_ref)
            n_new = torch.linalg.vector_norm(v_new)
        scale = torch.clamp(n_ref / (n_new + 1e-8), cfg_renorm_min, 1.0)
        return v_new * scale

    if cfg_renorm_type == "text_channel":
        v_t = v_text + cfg_text_scale * (v_cond - v_text)
        v_t = renorm(v_cond, v_t, per_token=True)
        if v_img is not None and cfg_img_scale > 1.0:
            return v_img + cfg_img_scale * (v_t - v_img)
        return v_t

    v_t = v_text + cfg_text_scale * (v_cond - v_text)
    if v_img is not None and cfg_img_scale > 1.0:
        v_t = v_img + cfg_img_scale * (v_t - v_img)
    if cfg_renorm_type == "global":
        return renorm(v_cond, v_t, per_token=False)
    if cfg_renorm_type == "channel":
        return renorm(v_cond, v_t, per_token=True)
    raise NotImplementedError(cfg_renorm_type)
