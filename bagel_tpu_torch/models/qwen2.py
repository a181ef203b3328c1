"""Qwen2 Mixture-of-Transformer-experts (MoT) decoder, inference half
(port of bagel_tpu/models/qwen2.py).

- Parameters keep the JAX tree: per-layer weights stacked on axis 0,
  `[in, out]` matrices, fused (`qkv`, `gate_up`) or separate leaves. The
  `lax.scan` over layers becomes a Python loop over `layers[...][i]`.
- The KV cache is a preallocated buffer `[L, B, S, KH, D]` with a per-row
  length. Writes are out of place, as in JAX: `llm_extend` never mutates the
  cache it is given. With `update_cache=True` it returns a new buffer; with
  `update_cache=False` each layer writes the block into a clone of the live
  prefix of its slice that is dropped after the attention. So contexts may share buffers
  (`GenContext.copy()`), exactly as JAX arrays do.
- MoT expert selection is by token position: tokens [0, und_len) use the
  und expert, the rest the gen expert, each running only its own matmuls.
- On a CUDA tensor with attn_impl="auto" every attention goes through the
  hand-written kernel (`ops.flash.flash_cached_attention`), prefill (causal)
  and denoise (non-causal) alike; any attn_impl other than "auto"/"flash"
  takes the dense path (`cache_block_mask` + `dot_attention`).

Quantized weight leaves, the int8 KV cache, decode and training come with
later slices.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F

from bagel_tpu_torch.configs import Qwen2Config
from bagel_tpu_torch.ops.attention import cache_block_mask, dot_attention
from bagel_tpu_torch.ops.flash import flash_cached_attention
from bagel_tpu_torch.ops.norms import rms_norm
from bagel_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from bagel_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class KVCache:
    """Append-only KV buffer. k/v: [L, B, S_max, KH, D]; length: [B] int32."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def kv_cache_init(
    cfg: Qwen2Config, batch: int, max_len: int, dtype=torch.bfloat16,
    device=None,
) -> KVCache:
    if dtype == torch.int8:
        raise NotImplementedError(
            "the int8 KV cache comes with the quantization slice"
        )
    device = resolve_device(device)
    shape = (cfg.num_hidden_layers, batch, max_len,
             cfg.num_key_value_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------


def _normal(generator, shape, std, dtype, device):
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def _stacked_dense(generator, L, d_in, d_out, dtype, device, bias, std=0.02):
    p = {"w": _normal(generator, (L, d_in, d_out), std, dtype, device)}
    if bias:
        p["b"] = torch.zeros((L, d_out), dtype=dtype, device=device)
    return p


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def init_qwen2_params(
    generator: torch.Generator, cfg: Qwen2Config, dtype=torch.bfloat16,
    device=None,
) -> dict:
    """Random-init parameter tree with per-layer weights stacked on axis 0.

    Gen-expert weights start as copies of the und weights and every norm
    weight as 1, mirroring upstream init_moe. `generator` must live on
    `device`.
    """
    device = resolve_device(device)
    L = cfg.num_hidden_layers
    d = cfg.hidden_size
    hd = cfg.head_dim
    qd = cfg.num_attention_heads * hd
    kvd = cfg.num_key_value_heads * hd
    f = cfg.intermediate_size
    g, dt, dev = generator, dtype, device

    attn = {
        "q": _stacked_dense(g, L, d, qd, dt, dev, True),
        "k": _stacked_dense(g, L, d, kvd, dt, dev, True),
        "v": _stacked_dense(g, L, d, kvd, dt, dev, True),
        "o": _stacked_dense(g, L, qd, d, dt, dev, False),
    }
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=dev)  # noqa: E731
    if cfg.qk_norm:
        attn["q_norm"] = ones(L, hd)
        attn["k_norm"] = ones(L, hd)
    mlp = {
        "gate": _normal(g, (L, d, f), 0.02, dt, dev),
        "up": _normal(g, (L, d, f), 0.02, dt, dev),
        "down": _normal(g, (L, f, d), 0.02, dt, dev),
    }
    layers = {"attn": attn, "mlp": mlp, "input_ln": ones(L, d), "post_ln": ones(L, d)}
    if cfg.layer_module == "mot":
        layers["attn_gen"] = _clone_tree(attn)
    if cfg.use_moe:
        layers["mlp_gen"] = _clone_tree(mlp)
    if cfg.layer_module == "mot":
        layers["input_ln_gen"] = ones(L, d)
        layers["post_ln_gen"] = ones(L, d)

    params = {
        "embed": _normal(g, (cfg.vocab_size, d), 0.02, dt, dev),
        "layers": layers,
        "final_norm": ones(d),
        "lm_head": {"w": _normal(g, (d, cfg.vocab_size), 0.02, dt, dev)},
    }
    if cfg.use_moe:
        params["final_norm_gen"] = ones(d)
    return params


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------


def _linear(x: torch.Tensor, p) -> torch.Tensor:
    """x @ w (+ b) over a plain weight leaf ({'w'[, 'b']} or a bare tensor).

    The bias is added in the matmul's epilogue (torch.addmm), in fp32 before
    the one rounding to x.dtype, as the JAX `preferred_element_type=f32`
    product does."""
    if not isinstance(p, dict):
        p = {"w": p}
    for leaf in ("w_q", "w_q8", "w_p4", "w_nf4"):
        if leaf in p:
            raise NotImplementedError(
                f"quantized weight leaf '{leaf}' comes with the quantization slice"
            )
    w = p["w"]
    if "b" not in p:
        return torch.matmul(x, w)
    out = torch.addmm(p["b"], x.reshape(-1, x.shape[-1]), w)
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


def _proj_qkv(x, attn, h, kh, hd):
    """(q, k, v) heads from either fused or separate projection leaves."""
    lead = x.shape[:-1]
    if "qkv" in attn:
        qkv = _linear(x, attn["qkv"])
        q, k, v = torch.split(qkv, [h * hd, kh * hd, kh * hd], dim=-1)
    else:
        q = _linear(x, attn["q"])
        k = _linear(x, attn["k"])
        v = _linear(x, attn["v"])
    return (q.reshape(lead + (h, hd)), k.reshape(lead + (kh, hd)),
            v.reshape(lead + (kh, hd)))


def _ffn_mix(z, mlp):
    """silu(gate) * up from fused or separate gate/up leaves."""
    if "gate_up" in mlp:
        gate, up = _linear(z, mlp["gate_up"]).chunk(2, dim=-1)
    else:
        gate = _linear(z, mlp["gate"])
        up = _linear(z, mlp["up"])
    return F.silu(gate) * up


# ---------------------------------------------------------------------------
# Layer forward (inference, block-extend over the KV cache)
# ---------------------------------------------------------------------------


def _split_apply(x, und_len: int, fn_und, fn_gen):
    """fn_und on x[:, :und_len], fn_gen on the rest, concatenated on axis 1;
    a single-expert block runs one function only."""
    t = x.shape[1]
    if und_len >= t:
        return fn_und(x)
    if und_len <= 0:
        return fn_gen(x)
    return torch.cat([fn_und(x[:, :und_len]), fn_gen(x[:, und_len:])], dim=1)


def _layer_params(layers: dict, i: int) -> dict:
    """Layer i's slice of the stacked parameter tree."""
    if isinstance(layers, dict):
        return {k: _layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def _layer_extend(
    cfg: Qwen2Config,
    und_len: int,
    causal: bool,
    x: torch.Tensor,  # [B, T, d]
    lp: dict,  # one layer's params
    k_buf: torch.Tensor,  # [B, S, KH, D], written in place (a private buffer)
    v_buf: torch.Tensor,
    past_len: torch.Tensor,  # [B] int32 on x's device
    past_host: List[int],  # the same lengths on the host
    q_valid: torch.Tensor,  # [B]
    cos: torch.Tensor,  # [B, T, D]
    sin: torch.Tensor,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """One decoder layer over a new token block; writes the block's K/V into
    k_buf/v_buf at [past_len, past_len + T) and returns the new x."""
    b, t, d = x.shape
    h = cfg.num_attention_heads
    kh = cfg.num_key_value_heads
    hd = cfg.head_dim
    mot = cfg.layer_module == "mot"

    attn_u = lp["attn"]
    attn_g = lp["attn_gen"] if mot else lp["attn"]
    ln_u = lp["input_ln"]
    ln_g = lp["input_ln_gen"] if mot else lp["input_ln"]

    res = x
    hqkv = _split_apply(
        x, und_len,
        lambda xu: rms_norm(xu, ln_u, cfg.rms_norm_eps),
        lambda xg: rms_norm(xg, ln_g, cfg.rms_norm_eps),
    )
    if und_len >= t:
        q, k, v = _proj_qkv(hqkv, attn_u, h, kh, hd)
    elif und_len <= 0:
        q, k, v = _proj_qkv(hqkv, attn_g, h, kh, hd)
    else:
        qu, ku, vu = _proj_qkv(hqkv[:, :und_len], attn_u, h, kh, hd)
        qg, kg, vg = _proj_qkv(hqkv[:, und_len:], attn_g, h, kh, hd)
        q = torch.cat([qu, qg], dim=1)
        k = torch.cat([ku, kg], dim=1)
        v = torch.cat([vu, vg], dim=1)

    if cfg.qk_norm:
        # fp32 QK-norm (upstream keeps it in fp32 on the gen path)
        def qknorm(z, w):
            return rms_norm(z.float(), w, cfg.rms_norm_eps)

        q = _split_apply(
            q, und_len,
            lambda z: qknorm(z, attn_u["q_norm"]),
            lambda z: qknorm(z, attn_g["q_norm"]),
        )
        k = _split_apply(
            k, und_len,
            lambda z: qknorm(z, attn_u["k_norm"]),
            lambda z: qknorm(z, attn_g["k_norm"]),
        )

    q, k = apply_rope(q, k, cos, sin)
    cdt = k_buf.dtype
    q = q.to(cdt)
    for row, off in enumerate(past_host):  # append the block at per-row offsets
        k_buf[row, off : off + t] = k[row]
        v_buf[row, off : off + t] = v[row]

    if attn_impl == "flash" or (attn_impl == "auto" and q.is_cuda):
        att = flash_cached_attention(
            q, k_buf, v_buf, past_len, q_valid, causal=causal
        )
    else:
        mask = cache_block_mask(k_buf.shape[1], t, past_len, q_valid, causal)
        att = dot_attention(q, k_buf, v_buf, mask=mask)
    att = att.reshape(b, t, h * hd)

    o = _split_apply(
        att, und_len,
        lambda z: _linear(z, attn_u["o"]),
        lambda z: _linear(z, attn_g["o"]),
    )
    x = res + o.to(res.dtype)

    res = x
    mlp_u = lp["mlp"]
    mlp_g = lp.get("mlp_gen", lp["mlp"])
    pln_u = lp["post_ln"]
    pln_g = lp["post_ln_gen"] if mot else lp["post_ln"]

    def ffn(mlp, pln):
        def f(z):
            z = rms_norm(z, pln, cfg.rms_norm_eps)
            return _linear(_ffn_mix(z, mlp), mlp["down"])

        return f

    m = _split_apply(x, und_len, ffn(mlp_u, pln_u), ffn(mlp_g, pln_g))
    return res + m.to(res.dtype)


def llm_extend(
    params: dict,
    cfg: Qwen2Config,
    embeds: torch.Tensor,  # [B, T, d] input embeddings for the new block
    position_ids: torch.Tensor,  # [B, T] rope positions
    cache: KVCache,
    q_valid: torch.Tensor,  # [B] valid tokens in the block
    *,
    und_len: int,
    causal: bool,
    update_cache: bool,
    attn_impl: str = "auto",
) -> Tuple[torch.Tensor, KVCache]:
    """Run the decoder stack over one new block of tokens.

    Returns final hidden states [B, T, d] (post final-norm, expert-selected)
    and the updated cache (the input cache itself if update_cache=False).
    The input cache is never modified.
    """
    t = embeds.shape[1]
    past_host = cache.length.tolist()
    for off in past_host:
        if off + t > cache.max_len:
            raise ValueError(
                f"KV buffer too small: length {off} + block {t} > {cache.max_len}"
            )
    q_valid = q_valid.to(torch.int32)
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)

    if update_cache:
        k_new, v_new = cache.k.clone(), cache.v.clone()
    # without update_cache the per-layer scratch buffer holds only the live
    # prefix: no key past it is visible, so the bucket's tail is never copied
    live = max(past_host) + t
    x = embeds
    for i in range(cfg.num_hidden_layers):
        if update_cache:
            k_buf, v_buf = k_new[i], v_new[i]
        else:
            k_buf, v_buf = cache.k[i, :, :live].clone(), cache.v[i, :, :live].clone()
        x = _layer_extend(
            cfg, und_len, causal, x, _layer_params(params["layers"], i),
            k_buf, v_buf, cache.length, past_host, q_valid, cos, sin,
            attn_impl=attn_impl,
        )

    fin_u = params["final_norm"]
    fin_g = params.get("final_norm_gen", fin_u)
    x = _split_apply(
        x, und_len,
        lambda z: rms_norm(z, fin_u, cfg.rms_norm_eps),
        lambda z: rms_norm(z, fin_g, cfg.rms_norm_eps),
    )
    if update_cache:
        return x, KVCache(k=k_new, v=v_new, length=cache.length + q_valid)
    return x, cache


def embed_tokens(params: dict, ids: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    if isinstance(emb, dict):
        raise NotImplementedError(
            "int8 embedding rows come with the quantization slice"
        )
    return emb[ids]


def lm_logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 (the inputs upcast, as preferred_element_type=f32)."""
    head = params["lm_head"]
    if "w" not in head:
        raise NotImplementedError(
            "a quantized lm_head comes with the quantization slice"
        )
    return torch.matmul(hidden.float(), head["w"].float())
