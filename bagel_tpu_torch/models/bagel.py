"""Bagel assembly of LLM + ViT + VAE adapters (port of bagel_tpu/models/bagel.py).

Adapters and helpers of the inference paths: the ViT -> LLM connector and
`encode_vit_tokens` (understanding), the timestep embedder, the latent <->
LLM projections, latent patchify, the shifted denoise schedule and
classifier-free-guidance combination (generation). Training:
`PackedTrainBatch` (one packed multi-sample sequence) and
`bagel_forward_train`, which assembles the sequence, runs the packed MoT
forward and returns per-element losses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bagel_tpu_torch.configs import BagelConfig
from bagel_tpu_torch.models import qwen2
from bagel_tpu_torch.models.siglip import init_siglip_params, siglip_encode
from bagel_tpu_torch.models.vae import init_vae_params
from bagel_tpu_torch.ops.attention import train_packed_mask
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
    promotes), the bias added in the matmul's epilogue (torch.addmm) before
    the one rounding, returned in x.dtype."""
    ct = torch.promote_types(x.dtype, p["w"].dtype)
    w = p["w"].to(ct)
    out = torch.addmm(p["b"].to(ct), x.reshape(-1, x.shape[-1]).to(ct), w)
    return out.reshape(x.shape[:-1] + (w.shape[-1],)).to(x.dtype)


def init_bagel_params(
    generator: torch.Generator, cfg: BagelConfig, dtype=torch.bfloat16,
    device=None,
) -> dict:
    """Parameter tree: llm / vit / vae / adapters, in the JAX layout.

    llm2vae starts at zero (upstream _init_weights). `generator` must live
    on `device`.
    """
    device = resolve_device(device)
    d = cfg.llm.hidden_size
    g, dev = generator, device
    params = {"llm": qwen2.init_qwen2_params(g, cfg.llm, dtype, dev)}
    if cfg.visual_und:
        params["vit"] = init_siglip_params(g, cfg.vit, dtype, dev)
        params["connector"] = {
            "fc1": _dense_init(g, cfg.vit.hidden_size, d, dtype, dev),
            "fc2": _dense_init(g, d, d, dtype, dev),
        }
        params["vit_pos_embed"] = sincos_2d_grid(
            d, cfg.vit_max_num_patch_per_side, device=dev
        ).to(dtype)
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


def connector_apply(params, x):
    """ViT hidden -> LLM hidden (upstream MLPconnector): fc2(gelu_tanh(fc1 x))."""
    h = _linear(x, params["connector"]["fc1"])
    return _linear(F.gelu(h, approximate="tanh"), params["connector"]["fc2"])


def encode_vit_tokens(params, cfg: BagelConfig, patches, pos_ids, seg_ids,
                      attn_impl: str = "auto"):
    """Packed image patches -> LLM-space embeddings (+ the frozen 2-D
    position table)."""
    h = siglip_encode(params["vit"], cfg.vit, patches, pos_ids, seg_ids,
                      attn_impl=attn_impl)
    h = connector_apply(params, h)
    return h + params["vit_pos_embed"][pos_ids.long()].to(h.dtype)


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


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedTrainBatch:
    """One packed multi-sample training sequence (the JAX dataclass's fields;
    numpy arrays or tensors).

    Scatter indexes into a fixed-length buffer plus mask metadata replace the
    reference's dict of index lists (bagel.py:101-150). Padding convention:
    the indexes of padded entries point at slot `seq_len - 1`, a sink with
    document_id 0 and zero loss weight."""

    # text
    text_ids: torch.Tensor  # [n_text] int32
    text_idx: torch.Tensor  # [n_text] scatter positions into the sequence
    # vit (may be empty)
    vit_patches: torch.Tensor  # [n_vit, vit_patch_dim]
    vit_pos_ids: torch.Tensor  # [n_vit]
    vit_seg_ids: torch.Tensor  # [n_vit] image index (1-based), 0 = pad
    vit_idx: torch.Tensor  # [n_vit]
    # vae/gen (may be empty); clean latent patches, patchified
    vae_patches: torch.Tensor  # [n_vae, patch_latent_dim]
    vae_pos_ids: torch.Tensor  # [n_vae]
    vae_idx: torch.Tensor  # [n_vae]
    vae_timesteps: torch.Tensor  # [n_vae] raw (pre-sigmoid) flow timesteps
    # sequence metadata
    position_ids: torch.Tensor  # [S]
    document_id: torch.Tensor  # [S] int32, 0 = pad
    fan_id: torch.Tensor  # [S] full-and-noise split id, -1 elsewhere
    noise_id: torch.Tensor  # [S] noise split id, -1 elsewhere
    gen_mask: torch.Tensor  # [S] bool
    # losses
    ce_idx: torch.Tensor  # [n_ce] sequence positions with CE loss
    ce_labels: torch.Tensor  # [n_ce]
    ce_weight: torch.Tensor  # [n_ce] float (len2weight * valid)
    mse_weight: torch.Tensor  # [n_vae] float (1.0 where this vae token has loss)

    @property
    def seq_len(self) -> int:
        return self.position_ids.shape[-1]

    def map(self, fn) -> "PackedTrainBatch":
        """A batch with fn applied to every field."""
        return PackedTrainBatch(**{f.name: fn(getattr(self, f.name))
                                   for f in dataclasses.fields(self)})

    def to(self, device) -> "PackedTrainBatch":
        """Every field as a tensor on `device` (numpy fields converted)."""
        return self.map(lambda x: torch.as_tensor(x).to(device))

    def row(self, b: int) -> "PackedTrainBatch":
        """Row b of a stacked batch (leading batch axis on every field)."""
        return self.map(lambda x: x[b])


def bagel_forward_train(
    params: dict,
    cfg: BagelConfig,
    batch: PackedTrainBatch,
    noise: torch.Tensor,  # [n_vae, patch_latent_dim] flow noise
    attn_chunk=None,
    context_parallel=None,
    sparse_block=None,
    expert_parallel=None,
    remat="full",
) -> Dict[str, torch.Tensor]:
    """Packed training forward -> per-element losses (upstream
    Bagel.forward, bagel.py:101-229): text embeds, ViT embeds and noised
    VAE latents scattered into one sequence; the packed mask; the MoT LLM;
    CE on ce_idx positions against the labels, MSE against (noise - x0) on
    vae tokens with timestep > 0.

    Returns 'ce' [n_ce], 'ce_weight', and with VAE tokens 'mse' [n_vae, pd]
    and 'mse_weight'; the weights zero out padding and no-loss entries, and
    the reduction happens in the train step (global token counts).
    `expert_parallel` raises (ROADMAP A, parallelism)."""
    if expert_parallel is not None:
        raise NotImplementedError(
            "expert_parallel (the MoT experts sharded over two devices) waits "
            "for the parallel slice of the port (ROADMAP A, parallelism)"
        )
    seq, timesteps = _assemble_train_seq(params, cfg, batch, noise)
    if attn_chunk is None and context_parallel is None and sparse_block is None:
        mask = train_packed_mask(batch.document_id, batch.fan_id, batch.noise_id)
        meta = None
    else:  # long sequences: no dense [S, S] mask
        mask = None
        meta = (batch.document_id, batch.fan_id, batch.noise_id)
    hidden = qwen2.llm_forward_train(
        params["llm"], cfg.llm, seq, batch.position_ids, mask, batch.gen_mask,
        remat=remat, mask_meta=meta, attn_chunk=attn_chunk,
        context_parallel=context_parallel, sparse_block=sparse_block,
    )
    return _train_heads(params, cfg, batch, noise, hidden, timesteps)


def _assemble_train_seq(params, cfg: BagelConfig, batch: PackedTrainBatch, noise):
    """Scatter text embeds, ViT embeds and noised VAE latents into one packed
    [S, d] sequence (upstream bagel.py:151-197). Returns (seq, timesteps)."""
    s = batch.seq_len
    emb = params["llm"]["embed"]
    seq = emb.new_zeros((s, cfg.llm.hidden_size))
    seq = seq.index_put((batch.text_idx.long(),),
                        qwen2.embed_tokens(params["llm"], batch.text_ids.long()).to(seq.dtype))

    if cfg.visual_und and batch.vit_patches.shape[0] > 0:
        vit_emb = encode_vit_tokens(params, cfg, batch.vit_patches.to(seq.dtype),
                                    batch.vit_pos_ids, batch.vit_seg_ids)
        seq = seq.index_put((batch.vit_idx.long(),), vit_emb.to(seq.dtype))

    timesteps = None
    if cfg.visual_gen and batch.vae_patches.shape[0] > 0:
        # sigmoid + shift of the raw timesteps (upstream bagel.py:191-192)
        tt = torch.sigmoid(batch.vae_timesteps)
        ts = cfg.timestep_shift
        timesteps = ts * tt / (1 + (ts - 1) * tt)
        x0 = batch.vae_patches
        x_t = (1 - timesteps[:, None]) * x0 + timesteps[:, None] * noise
        lat_emb = latent_to_llm(params, cfg, x_t.to(seq.dtype), timesteps,
                                batch.vae_pos_ids.long())
        seq = seq.index_put((batch.vae_idx.long(),), lat_emb.to(seq.dtype))
    return seq, timesteps


def _train_heads(params, cfg: BagelConfig, batch: PackedTrainBatch, noise, hidden,
                 timesteps) -> Dict[str, torch.Tensor]:
    """Loss heads over the final hidden states: llm2vae -> per-element MSE
    against (noise - x0) on vae tokens, lm_head -> per-token CE on ce_idx
    positions (upstream bagel.py:217-229)."""
    out: Dict[str, torch.Tensor] = {}
    if cfg.visual_gen and batch.vae_patches.shape[0] > 0:
        v_pred = _linear(hidden[batch.vae_idx.long()], params["llm2vae"])
        target = noise - batch.vae_patches  # v = x1 - x0 (upstream bagel.py:220)
        out["mse"] = (v_pred.float() - target) ** 2
        out["mse_weight"] = batch.mse_weight * (timesteps > 0)
    logits = qwen2.lm_logits(params["llm"], hidden[batch.ce_idx.long()])
    logp = torch.log_softmax(logits.float(), dim=-1)
    out["ce"] = -logp.gather(1, batch.ce_labels.long()[:, None])[:, 0]
    out["ce_weight"] = batch.ce_weight
    return out
