"""Checkpoint conversion: upstream state dicts <-> the port's parameter tree
(port of bagel_tpu/utils/convert.py).

`convert_*` read the released BAGEL checkpoint layout ({llm_config.json,
vit_config.json, ae.safetensors, ema.safetensors, tokenizer}) or any state
dict with upstream's module names (torch tensors, or numpy arrays) and
build the tree `utils.bridge.params_from_numpy` gives, as CPU tensors:
- per-layer weights stacked on a leading L axis;
- torch Linear [out, in] -> [in, out];
- the ViT's conv patch embedding -> a Linear over flattened (p, q, c)
  patches;
- `*_moe_gen` names -> the `*_gen` subtrees;
- VAE conv kernels stay OIHW, the port's layout (the JAX tree's is HWIO);
- the fixed sin-cos tables (vit_pos_embed, latent_pos_embed) are dropped
  and made again from the config, so a checkpoint retargets to another
  resolution for free.
`export_*` are the inverse, to upstream's key space, and
`save_checkpoint_dir` / `load_checkpoint_dir` write and read the release
layout with safetensors (imported where a file is read or written).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from bagel_tpu_torch.configs import BagelConfig, Qwen2Config, SiglipConfig, VAEConfig
from bagel_tpu_torch.ops.embeds import sincos_2d_grid
from bagel_tpu_torch.utils.bridge import _to_tensor


def _a(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else _to_tensor(x)


def _t(x) -> torch.Tensor:  # torch Linear -> [in, out]
    return _a(x).T.contiguous()


def _conv(sd, name):  # OIHW, as stored
    return {"w": _a(sd[name + ".weight"]), "b": _a(sd[name + ".bias"])}


def _gn(sd, name):
    return {"w": _a(sd[name + ".weight"]), "b": _a(sd[name + ".bias"])}


def _stack(mats, transpose: bool) -> torch.Tensor:
    arr = torch.stack([_a(m) for m in mats], 0)
    if transpose and arr.ndim == 3:
        arr = arr.transpose(1, 2)
    return arr.contiguous()


def convert_llm(sd: Dict, cfg: Qwen2Config, prefix: str = "language_model.") -> dict:
    L = cfg.num_hidden_layers

    def stack(fmt, transpose=True):
        return _stack([sd[prefix + fmt.format(i)] for i in range(L)], transpose)

    def attn(g=""):
        p = "model.layers.{0}.self_attn."
        out = {
            "q": {"w": stack(p + f"q_proj{g}.weight"), "b": stack(p + f"q_proj{g}.bias", False)},
            "k": {"w": stack(p + f"k_proj{g}.weight"), "b": stack(p + f"k_proj{g}.bias", False)},
            "v": {"w": stack(p + f"v_proj{g}.weight"), "b": stack(p + f"v_proj{g}.bias", False)},
            "o": {"w": stack(p + f"o_proj{g}.weight")},
        }
        if cfg.qk_norm:
            out["q_norm"] = stack(p + f"q_norm{g}.weight", False)
            out["k_norm"] = stack(p + f"k_norm{g}.weight", False)
        return out

    def mlp(g=""):
        return {
            "gate": stack("model.layers.{0}.mlp%s.gate_proj.weight" % g),
            "up": stack("model.layers.{0}.mlp%s.up_proj.weight" % g),
            "down": stack("model.layers.{0}.mlp%s.down_proj.weight" % g),
        }

    layers = {
        "attn": attn(""),
        "mlp": mlp(""),
        "input_ln": stack("model.layers.{0}.input_layernorm.weight", False),
        "post_ln": stack("model.layers.{0}.post_attention_layernorm.weight", False),
    }
    if cfg.layer_module == "mot":
        layers["attn_gen"] = attn("_moe_gen")
        layers["input_ln_gen"] = stack("model.layers.{0}.input_layernorm_moe_gen.weight", False)
        layers["post_ln_gen"] = stack(
            "model.layers.{0}.post_attention_layernorm_moe_gen.weight", False)
    if cfg.use_moe:
        layers["mlp_gen"] = mlp("_moe_gen")
    params = {
        "embed": _a(sd[prefix + "model.embed_tokens.weight"]),
        "layers": layers,
        "final_norm": _a(sd[prefix + "model.norm.weight"]),
        "lm_head": {"w": _t(sd[prefix + "lm_head.weight"])},
    }
    if cfg.use_moe:
        params["final_norm_gen"] = _a(sd[prefix + "model.norm_moe_gen.weight"])
    return params


def convert_vit(sd: Dict, cfg: SiglipConfig, prefix: str = "vit_model.") -> dict:
    L = cfg.num_hidden_layers
    vp = prefix + "vision_model."

    def stack(fmt, transpose=True):
        return _stack([sd[vp + f"encoder.layers.{i}.{fmt}"] for i in range(L)], transpose)

    def pair(p):
        return {"w": stack(p + ".weight"), "b": stack(p + ".bias", False)}

    pe_w = _a(sd[vp + "embeddings.patch_embedding.weight"])
    if pe_w.ndim == 4:  # conv OIHW -> linear [p*p*c, out] in (p, q, c) order
        pe_w = pe_w.permute(0, 2, 3, 1).reshape(pe_w.shape[0], -1).T
    else:  # already a linear [out, in]
        pe_w = pe_w.T
    params = {
        "patch_embed": {"w": pe_w.contiguous(),
                        "b": _a(sd[vp + "embeddings.patch_embedding.bias"])},
        "layers": {
            "ln1": {"w": stack("layer_norm1.weight", False), "b": stack("layer_norm1.bias", False)},
            "ln2": {"w": stack("layer_norm2.weight", False), "b": stack("layer_norm2.bias", False)},
            "attn": {
                "q": pair("self_attn.q_proj"),
                "k": pair("self_attn.k_proj"),
                "v": pair("self_attn.v_proj"),
                "o": pair("self_attn.out_proj"),
            },
            "mlp": {"fc1": pair("mlp.fc1"), "fc2": pair("mlp.fc2")},
        },
        "post_ln": _gn(sd, vp[:-1] + ".post_layernorm"),
    }
    if not cfg.rope:
        params["pos_embed"] = _a(sd[vp + "embeddings.position_embedding.weight"])
    return params


def convert_vae(sd: Dict, cfg: VAEConfig) -> dict:
    def res(name):
        p = {
            "norm1": _gn(sd, name + ".norm1"), "conv1": _conv(sd, name + ".conv1"),
            "norm2": _gn(sd, name + ".norm2"), "conv2": _conv(sd, name + ".conv2"),
        }
        if name + ".nin_shortcut.weight" in sd:
            p["shortcut"] = _conv(sd, name + ".nin_shortcut")
        return p

    def attn(name):
        return {
            "norm": _gn(sd, name + ".norm"),
            "q": _conv(sd, name + ".q"), "k": _conv(sd, name + ".k"),
            "v": _conv(sd, name + ".v"), "proj": _conv(sd, name + ".proj_out"),
        }

    n_levels = len(cfg.ch_mult)
    enc = {
        "conv_in": _conv(sd, "encoder.conv_in"),
        "levels": [
            {
                "blocks": [res(f"encoder.down.{i}.block.{j}") for j in range(cfg.num_res_blocks)],
                **({"down": _conv(sd, f"encoder.down.{i}.downsample.conv")}
                   if i != n_levels - 1 else {}),
            }
            for i in range(n_levels)
        ],
        "mid": {
            "block1": res("encoder.mid.block_1"),
            "attn": attn("encoder.mid.attn_1"),
            "block2": res("encoder.mid.block_2"),
        },
        "norm_out": _gn(sd, "encoder.norm_out"),
        "conv_out": _conv(sd, "encoder.conv_out"),
    }
    dec = {
        "conv_in": _conv(sd, "decoder.conv_in"),
        "mid": {
            "block1": res("decoder.mid.block_1"),
            "attn": attn("decoder.mid.attn_1"),
            "block2": res("decoder.mid.block_2"),
        },
        "up": [
            {
                "blocks": [res(f"decoder.up.{i}.block.{j}")
                           for j in range(cfg.num_res_blocks + 1)],
                **({"up": _conv(sd, f"decoder.up.{i}.upsample.conv")} if i != 0 else {}),
            }
            for i in range(n_levels)
        ],
        "norm_out": _gn(sd, "decoder.norm_out"),
        "conv_out": _conv(sd, "decoder.conv_out"),
    }
    return {"encoder": enc, "decoder": dec}


def convert_bagel(sd: Dict, cfg: BagelConfig, vae_sd: Optional[Dict] = None) -> dict:
    """A full BAGEL state dict -> the parameter tree (CPU tensors); the
    sin-cos tables are made from cfg."""
    d = cfg.llm.hidden_size
    params = {"llm": convert_llm(sd, cfg.llm)}
    if cfg.visual_und:
        params["vit"] = convert_vit(sd, cfg.vit)
        params["connector"] = {
            k: {"w": _t(sd[f"connector.{k}.weight"]), "b": _a(sd[f"connector.{k}.bias"])}
            for k in ("fc1", "fc2")
        }
        params["vit_pos_embed"] = sincos_2d_grid(d, cfg.vit_max_num_patch_per_side, device="cpu")
    if cfg.visual_gen:
        params["time_embed"] = {
            ours: {"w": _t(sd[f"time_embedder.{theirs}.weight"]),
                   "b": _a(sd[f"time_embedder.{theirs}.bias"])}
            for ours, theirs in (("fc1", "mlp.0"), ("fc2", "mlp.2"))
        }
        for name in ("vae2llm", "llm2vae"):
            params[name] = {"w": _t(sd[f"{name}.weight"]), "b": _a(sd[f"{name}.bias"])}
        params["latent_pos_embed"] = sincos_2d_grid(d, cfg.max_latent_size, device="cpu")
        if vae_sd is not None:
            params["vae"] = convert_vae(vae_sd, cfg.vae)
    return params


def load_checkpoint_dir(path: str, cfg: BagelConfig, use_ema: bool = True) -> dict:
    """The parameter tree (CPU tensors, the file's dtypes) of a released
    BAGEL checkpoint directory: ema.safetensors (or model.safetensors) and,
    if present, ae.safetensors. `utils.bridge.params_to` moves it."""
    from safetensors.torch import load_file

    sd = load_file(os.path.join(path, "ema.safetensors" if use_ema else "model.safetensors"))
    ae_path = os.path.join(path, "ae.safetensors")
    vae_sd = load_file(ae_path) if os.path.exists(ae_path) else None
    return convert_bagel(sd, cfg, vae_sd)


# ---------------------------------------------------------------------------
# Export: the parameter tree -> upstream state dicts (torch tensors)
# ---------------------------------------------------------------------------


def _unstack_t(arr) -> Dict[int, torch.Tensor]:
    """[L, in, out] -> per-layer torch Linear [out, in] ([L, d] -> [d])."""
    return {i: (arr[i].T if arr.ndim == 3 else arr[i]).contiguous()
            for i in range(arr.shape[0])}


def _unstack(arr) -> Dict[int, torch.Tensor]:
    return {i: arr[i].contiguous() for i in range(arr.shape[0])}


def _unconv(out: Dict, name: str, p: dict) -> None:
    out[name + ".weight"] = p["w"].contiguous()  # OIHW already
    out[name + ".bias"] = p["b"]


def _ungn(out: Dict, name: str, p: dict) -> None:
    out[name + ".weight"] = p["w"]
    out[name + ".bias"] = p["b"]


def export_llm(params: dict, cfg: Qwen2Config, prefix: str = "language_model.") -> Dict:
    L = cfg.num_hidden_layers
    layers = params["layers"]
    out: Dict[str, torch.Tensor] = {}

    def put(fmt, per_layer):
        for i in range(L):
            out[prefix + fmt.format(i)] = per_layer[i]

    def attn(tree, g=""):
        p = "model.layers.{0}.self_attn."
        for k in ("q", "k", "v"):
            put(p + f"{k}_proj{g}.weight", _unstack_t(tree[k]["w"]))
            put(p + f"{k}_proj{g}.bias", _unstack(tree[k]["b"]))
        put(p + f"o_proj{g}.weight", _unstack_t(tree["o"]["w"]))
        if cfg.qk_norm:
            put(p + f"q_norm{g}.weight", _unstack(tree["q_norm"]))
            put(p + f"k_norm{g}.weight", _unstack(tree["k_norm"]))

    def mlp(tree, g=""):
        for ours, theirs in (("gate", "gate_proj"), ("up", "up_proj"), ("down", "down_proj")):
            put("model.layers.{0}.mlp%s.%s.weight" % (g, theirs), _unstack_t(tree[ours]))

    attn(layers["attn"])
    mlp(layers["mlp"])
    put("model.layers.{0}.input_layernorm.weight", _unstack(layers["input_ln"]))
    put("model.layers.{0}.post_attention_layernorm.weight", _unstack(layers["post_ln"]))
    if cfg.layer_module == "mot":
        attn(layers["attn_gen"], "_moe_gen")
        put("model.layers.{0}.input_layernorm_moe_gen.weight", _unstack(layers["input_ln_gen"]))
        put("model.layers.{0}.post_attention_layernorm_moe_gen.weight",
            _unstack(layers["post_ln_gen"]))
    if cfg.use_moe:
        mlp(layers["mlp_gen"], "_moe_gen")
        out[prefix + "model.norm_moe_gen.weight"] = params["final_norm_gen"]
    out[prefix + "model.embed_tokens.weight"] = params["embed"]
    out[prefix + "model.norm.weight"] = params["final_norm"]
    out[prefix + "lm_head.weight"] = params["lm_head"]["w"].T.contiguous()
    return out


def export_vit(params: dict, cfg: SiglipConfig, prefix: str = "vit_model.") -> Dict:
    L = cfg.num_hidden_layers
    vp = prefix + "vision_model."
    layers = params["layers"]
    out: Dict[str, torch.Tensor] = {}

    def put(fmt, per_layer):
        for i in range(L):
            out[vp + f"encoder.layers.{i}.{fmt}"] = per_layer[i]

    def pair(name, tree):
        put(name + ".weight", _unstack_t(tree["w"]))
        put(name + ".bias", _unstack(tree["b"]))

    # the patch embedding back to the released conv: [p*q*c, out] with
    # (p, q, c) input order -> [out, c, p, q]
    p = cfg.patch_size
    pe = params["patch_embed"]["w"]
    out[vp + "embeddings.patch_embedding.weight"] = (
        pe.T.reshape(pe.shape[1], p, p, 3).permute(0, 3, 1, 2).contiguous())
    out[vp + "embeddings.patch_embedding.bias"] = params["patch_embed"]["b"]
    pair("layer_norm1", layers["ln1"])
    pair("layer_norm2", layers["ln2"])
    pair("self_attn.q_proj", layers["attn"]["q"])
    pair("self_attn.k_proj", layers["attn"]["k"])
    pair("self_attn.v_proj", layers["attn"]["v"])
    pair("self_attn.out_proj", layers["attn"]["o"])
    pair("mlp.fc1", layers["mlp"]["fc1"])
    pair("mlp.fc2", layers["mlp"]["fc2"])
    _ungn(out, vp[:-1] + ".post_layernorm", params["post_ln"])
    if "pos_embed" in params:
        out[vp + "embeddings.position_embedding.weight"] = params["pos_embed"]
    else:
        # the 2-D RoPE buffers upstream keeps (deterministic from the
        # config), so that a strict load sees a complete state dict
        max_size = cfg.image_size // cfg.patch_size
        dim = (cfg.hidden_size // cfg.num_attention_heads) // 2
        inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2) / dim))
        grid = np.arange(max_size, dtype=np.float64)
        gh = np.repeat(grid[:, None], max_size, axis=1)
        gw = np.repeat(grid[None, :], max_size, axis=0)
        for side, g in (("h", gh), ("w", gw)):
            freqs = g[..., None] * inv_freq[None, None, :]
            emb = np.concatenate([freqs, freqs], -1).reshape(max_size * max_size, -1)
            emb = emb.astype(np.float32)
            out[vp + f"rope.cos_{side}"] = torch.from_numpy(np.cos(emb))
            out[vp + f"rope.sin_{side}"] = torch.from_numpy(np.sin(emb))
    return out


def export_vae(params: dict, cfg: VAEConfig) -> Dict:
    out: Dict[str, torch.Tensor] = {}

    def res(name, tree):
        _ungn(out, name + ".norm1", tree["norm1"])
        _unconv(out, name + ".conv1", tree["conv1"])
        _ungn(out, name + ".norm2", tree["norm2"])
        _unconv(out, name + ".conv2", tree["conv2"])
        if "shortcut" in tree:
            _unconv(out, name + ".nin_shortcut", tree["shortcut"])

    def attn(name, tree):
        _ungn(out, name + ".norm", tree["norm"])
        for k in ("q", "k", "v"):
            _unconv(out, name + "." + k, tree[k])
        _unconv(out, name + ".proj_out", tree["proj"])

    enc, dec = params["encoder"], params["decoder"]
    _unconv(out, "encoder.conv_in", enc["conv_in"])
    for i, lvl in enumerate(enc["levels"]):
        for j, blk in enumerate(lvl["blocks"]):
            res(f"encoder.down.{i}.block.{j}", blk)
        if "down" in lvl:
            _unconv(out, f"encoder.down.{i}.downsample.conv", lvl["down"])
    res("encoder.mid.block_1", enc["mid"]["block1"])
    attn("encoder.mid.attn_1", enc["mid"]["attn"])
    res("encoder.mid.block_2", enc["mid"]["block2"])
    _ungn(out, "encoder.norm_out", enc["norm_out"])
    _unconv(out, "encoder.conv_out", enc["conv_out"])
    _unconv(out, "decoder.conv_in", dec["conv_in"])
    res("decoder.mid.block_1", dec["mid"]["block1"])
    attn("decoder.mid.attn_1", dec["mid"]["attn"])
    res("decoder.mid.block_2", dec["mid"]["block2"])
    for i, lvl in enumerate(dec["up"]):
        for j, blk in enumerate(lvl["blocks"]):
            res(f"decoder.up.{i}.block.{j}", blk)
        if "up" in lvl:
            _unconv(out, f"decoder.up.{i}.upsample.conv", lvl["up"])
    _ungn(out, "decoder.norm_out", dec["norm_out"])
    _unconv(out, "decoder.conv_out", dec["conv_out"])
    return out


def export_bagel(params: dict, cfg: BagelConfig) -> Dict:
    """The tree -> upstream's BAGEL state dict (without the VAE, which the
    release ships as ae.safetensors). The sin-cos tables go out under their
    upstream names (vit_pos_embed.pos_embed, latent_pos_embed.pos_embed)."""
    sd = export_llm(params["llm"], cfg.llm)
    if cfg.visual_und and "vit" in params:
        sd.update(export_vit(params["vit"], cfg.vit))
        for k in ("fc1", "fc2"):
            sd[f"connector.{k}.weight"] = params["connector"][k]["w"].T.contiguous()
            sd[f"connector.{k}.bias"] = params["connector"][k]["b"]
        sd["vit_pos_embed.pos_embed"] = params["vit_pos_embed"]
    if cfg.visual_gen and "time_embed" in params:
        for ours, theirs in (("fc1", "mlp.0"), ("fc2", "mlp.2")):
            sd[f"time_embedder.{theirs}.weight"] = params["time_embed"][ours]["w"].T.contiguous()
            sd[f"time_embedder.{theirs}.bias"] = params["time_embed"][ours]["b"]
        for name in ("vae2llm", "llm2vae"):
            sd[f"{name}.weight"] = params[name]["w"].T.contiguous()
            sd[f"{name}.bias"] = params[name]["b"]
        sd["latent_pos_embed.pos_embed"] = params["latent_pos_embed"]
    return sd


def save_checkpoint_dir(params: dict, cfg: BagelConfig, path: str, ema: bool = True) -> None:
    """Write the release layout: model.safetensors (and an ema.safetensors
    copy with ema=True) and, when the tree has VAE weights,
    ae.safetensors."""
    from safetensors.torch import save_file

    def host(sd):
        # each tensor its own storage: safetensors refuses views of one buffer
        return {k: v.detach().cpu().contiguous().clone() for k, v in sd.items()}

    os.makedirs(path, exist_ok=True)
    sd = host(export_bagel(params, cfg))
    save_file(sd, os.path.join(path, "model.safetensors"))
    if ema:
        save_file(sd, os.path.join(path, "ema.safetensors"))
    if "vae" in params:
        save_file(host(export_vae(params["vae"], cfg.vae)), os.path.join(path, "ae.safetensors"))
