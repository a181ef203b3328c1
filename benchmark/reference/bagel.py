"""The plain reference of BAGEL-7B-MoT in float32 PyTorch.

Written from upstream's description (ByteDance-Seed/Bagel: modeling/bagel/
bagel.py, qwen2_navit.py, siglip_navit.py, autoencoder.py) over the
benchmark's own weight tree (`benchmark/harness/weights.py`): no kernel, no
cache, no batching, one sequence at a time, every product in float32 with
TF32 off. It imports nothing of the program.

A sequence is given as its token embeddings, their rope positions, which
expert each takes (`gen`), and a block id a token (`group`): token i sees
token j where j <= i or both lie in one block (an image's tokens see each
other whole, as upstream's non-causal image splits).

`quant="int8"` is the control: every linear of the decoder layers with its
weight rounded per output column and its input per row to int8 codes
(symmetric absmax scales), the product in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

HEAD_GROUP = 7  # query heads a chunk of the attention (one KV head of BAGEL's)


def fp32_mode() -> None:
    """Full float32 products: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to int8 codes with one absmax scale along `dim`, as floats."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.round(x / s).clamp_(-127, 127) * s


def linear(x, p, quant: Optional[str] = None):
    w = p["w"].float() if isinstance(p, dict) else p.float()
    if quant == "int8":
        x, w = _q8(x, -1), _q8(w, 0)
    y = x @ w
    if isinstance(p, dict) and "b" in p:
        y = y + p["b"].float()
    return y


def rms(x, w, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def rope_1d(pos: torch.Tensor, dim: int, theta: float):
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device) / dim)
    f = pos.float()[:, None] * inv
    e = torch.cat([f, f], -1)
    return e.cos()[:, None], e.sin()[:, None]  # [T, 1, dim]


def attend(q, k, v, mask):
    """q [T, H, D], k/v [S, KH, D], mask [T, S] bool -> [T, H*D]; softmax in
    float32, heads in chunks."""
    t, h, d = q.shape
    g = h // k.shape[1]
    out = torch.empty((t, h, d), dtype=torch.float32, device=q.device)
    neg = torch.finfo(torch.float32).min
    for h0 in range(0, h, HEAD_GROUP):
        hs = range(h0, min(h, h0 + HEAD_GROUP))
        kk = torch.stack([k[:, j // g] for j in hs], 0)  # [n, S, D]
        vv = torch.stack([v[:, j // g] for j in hs], 0)
        s = torch.einsum("thd,hsd->hts", q[:, h0:h0 + len(hs)], kk) / math.sqrt(d)
        s = s.masked_fill(~mask[None], neg)
        p = torch.softmax(s, -1) * mask[None]
        out[:, h0:h0 + len(hs)] = torch.einsum("hts,hsd->thd", p, vv)
    return out.reshape(t, h * d)


def seq_mask(group: torch.Tensor) -> torch.Tensor:
    i = torch.arange(group.shape[0], device=group.device)
    return (i[None, :] <= i[:, None]) | (group[None, :] == group[:, None])


def _layer(tree, i):
    return {k: _layer(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def decoder(llm: dict, c: dict, x, pos, gen, group, quant=None):
    """The MoT decoder over one sequence: x [T, d] float32 embeddings ->
    final hidden states [T, d] (each token through its expert's final norm)."""
    nh, kh = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c["hidden_size"] // nh
    eps = c.get("rms_norm_eps", 1e-6)
    cos, sin = rope_1d(pos, hd, c["rope_theta"])
    mask = seq_mask(group)
    idx = [torch.nonzero(~gen)[:, 0], torch.nonzero(gen)[:, 0]]
    sfx = ["", "_gen"]

    def per_expert(z, fn):
        out = None
        for e in (0, 1):
            if idx[e].numel():
                y = fn(z[idx[e]], e)
                if out is None:
                    out = y.new_empty((z.shape[0],) + y.shape[1:])
                out[idx[e]] = y
        return out

    for i in range(c["num_hidden_layers"]):
        lp = _layer(llm["layers"], i)

        def qkv(z, e):
            a = lp["attn" + sfx[e]]
            z = rms(z, lp["input_ln" + sfx[e]], eps)
            q = linear(z, a["q"], quant).view(-1, nh, hd)
            k = linear(z, a["k"], quant).view(-1, kh, hd)
            v = linear(z, a["v"], quant).view(-1, kh, hd)
            if "q_norm" in a:
                q, k = rms(q, a["q_norm"], eps), rms(k, a["k_norm"], eps)
            return torch.cat([q, k, v], 1)

        qkv_all = per_expert(x, qkv)
        q, k, v = qkv_all.split([nh, kh, kh], 1)
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        att = attend(q, k, v, mask)
        x = x + per_expert(att, lambda z, e: linear(z, lp["attn" + sfx[e]]["o"], quant))

        def ffn(z, e):
            m = lp["mlp" + sfx[e]]
            z = rms(z, lp["post_ln" + sfx[e]], eps)
            return linear(F.silu(linear(z, m["gate"], quant)) * linear(z, m["up"], quant),
                          m["down"], quant)

        x = x + per_expert(x, ffn)
        del qkv_all, q, k, v, att
    return per_expert(x, lambda z, e: rms(z, llm["final_norm" + sfx[e]], eps))


def logits(llm: dict, hidden):
    return hidden @ llm["lm_head"]["w"].float()


def embed(llm: dict, ids: torch.Tensor):
    return llm["embed"][ids.long()].float()


# -- generation adapters -----------------------------------------------------


def timestep_embedding(t: torch.Tensor, dim: int = 256):
    half = dim // 2
    f = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                    device=t.device) / half)
    a = t.float()[:, None] * f[None]
    return torch.cat([a.cos(), a.sin()], -1)


def latent_embeddings(params: dict, x_t, t: float, lat_pos):
    """vae2llm(x_t) + time_embed(t) + the latent position table."""
    n = x_t.shape[0]
    tv = torch.full((n,), float(t), dtype=torch.float32, device=x_t.device)
    te = linear(F.silu(linear(timestep_embedding(tv), params["time_embed"]["fc1"])),
                params["time_embed"]["fc2"])
    return linear(x_t.float(), params["vae2llm"]) + te + params["latent_pos_embed"][lat_pos].float()


def latent_positions(px_h: int, px_w: int, down: int, side: int, device):
    h, w = px_h // down, px_w // down
    return (torch.arange(h, device=device)[:, None] * side
            + torch.arange(w, device=device)[None, :]).reshape(-1)


def shifted_timesteps(n: int, shift: float):
    """(timesteps [n-1], dts [n-1]) float32: linspace(1, 0) under the shift
    s t / (1 + (s - 1) t), each operation in float32."""
    f32 = np.float32
    i = np.arange(n - 1, dtype=f32)
    t = np.append(f32(1.0) - i * (f32(1.0) / f32(n - 1)), f32(0.0))
    t = f32(shift) * t / (f32(1.0) + f32(shift - 1.0) * t)
    return t[:-1], t[:-1] - t[1:]


def cfg_combine(v_cond, v_text, v_img, text_scale, img_scale):
    """Dual classifier-free guidance with global renormalisation
    (upstream bagel.py:873-902, cfg_renorm_type "global", renorm_min 0)."""
    if v_text is None or text_scale <= 1.0:
        return v_cond
    v = v_text + text_scale * (v_cond - v_text)
    if v_img is not None and img_scale > 1.0:
        v = v_img + img_scale * (v - v_img)
    scale = torch.clamp(v_cond.norm() / (v.norm() + 1e-8), 0.0, 1.0)
    return v * scale


def gen_velocity(params: dict, c: dict, ctx_ids, x_t, t: float, lat_pos, ids: dict,
                 quant=None):
    """One branch's velocity [N, pd]: the context's text ids (bos, prompt,
    eos; empty for the cfg_text branch) causal through the und expert, then
    the block [start, end, latents at t] at one rope position, the two
    boundary tokens through the und expert and the latents through the gen
    expert."""
    llm, lc = params["llm"], c["llm"]
    dev = x_t.device
    n_ctx = len(ctx_ids)
    parts = []
    if n_ctx:
        parts.append(embed(llm, torch.as_tensor(ctx_ids, device=dev)))
    parts.append(embed(llm, torch.as_tensor([ids["start_of_image"], ids["end_of_image"]],
                                            device=dev)))
    parts.append(latent_embeddings(params, x_t, t, lat_pos))
    x = torch.cat(parts)
    n = x_t.shape[0]
    pos = torch.cat([torch.arange(n_ctx, device=dev), torch.full((n + 2,), n_ctx, device=dev)])
    gen = torch.zeros(x.shape[0], dtype=torch.bool, device=dev)
    gen[n_ctx + 2:] = True
    group = torch.cat([torch.arange(n_ctx, device=dev), torch.full((n + 2,), n_ctx, device=dev)])
    hid = decoder(llm, lc, x, pos, gen, group, quant)
    return linear(hid[n_ctx + 2:], params["llm2vae"])


# -- understanding -------------------------------------------------------------


def siglip(vit: dict, c: dict, patches, pos_ids):
    """One image's patches [n, 3 p p] (row-major patch grid, flattened
    (py, px, c)) -> [n, hidden]: pre-LN ViT, 2-D axial rope over the grid
    (first half of each head by row, second by column), full attention."""
    n = patches.shape[0]
    h, L = c["num_attention_heads"], c["num_hidden_layers"]
    hd = c["hidden_size"] // h
    eps = c.get("layer_norm_eps", 1e-6)
    side = c["image_size"] // c["patch_size"]
    rows, cols = (pos_ids // side).float(), (pos_ids % side).float()
    q4 = hd // 2
    inv = 1.0 / 10000.0 ** (torch.arange(0, q4, 2, dtype=torch.float32,
                                         device=patches.device) / q4)

    def tab(coord):
        f = coord[:, None] * inv
        e = torch.cat([f, f], -1)
        return e.cos()[:, None], e.sin()[:, None]

    (ch, sh), (cw, sw) = tab(rows), tab(cols)

    def rot(z):
        a, b = z[..., :q4], z[..., q4:]
        return torch.cat([a * ch + rotate_half(a) * sh, b * cw + rotate_half(b) * sw], -1)

    def ln(z, p):
        return F.layer_norm(z, z.shape[-1:], p["w"].float(), p["b"].float(), eps)

    x = linear(patches.float(), vit["patch_embed"])
    full = torch.ones((n, n), dtype=torch.bool, device=x.device)
    for i in range(L):
        lp = _layer(vit["layers"], i)
        y = ln(x, lp["ln1"])
        q = rot(linear(y, lp["attn"]["q"]).view(n, h, hd))
        k = rot(linear(y, lp["attn"]["k"]).view(n, h, hd))
        v = linear(y, lp["attn"]["v"]).view(n, h, hd)
        x = x + linear(attend(q, k, v, full), lp["attn"]["o"])
        y = ln(x, lp["ln2"])
        x = x + linear(F.gelu(linear(y, lp["mlp"]["fc1"]), approximate="tanh"), lp["mlp"]["fc2"])
    return ln(x, vit["post_ln"])


def image_patches(image: np.ndarray, patch: int, side: int):
    """An HWC image in [-1, 1] -> (patches [n, p*p*3], position ids [n]):
    centre-cropped to a multiple of the patch, row-major patch grid."""
    hh, ww = image.shape[0] // patch * patch, image.shape[1] // patch * patch
    oh, ow = (image.shape[0] - hh) // 2, (image.shape[1] - ww) // 2
    im = image[oh:oh + hh, ow:ow + ww]
    gh, gw = hh // patch, ww // patch
    p = im.reshape(gh, patch, gw, patch, 3).transpose(0, 2, 1, 3, 4).reshape(gh * gw, -1)
    pos = (np.arange(gh)[:, None] * side + np.arange(gw)[None, :]).reshape(-1)
    return p, pos


def chat_logits(params: dict, c: dict, prompt_ids, image, served, ids: dict):
    """Logits [len(served), V] of each served token's position: the image
    (if any) as one block [start, end, ViT tokens] at rope 0, then bos,
    prompt, eos causal, then the decode inputs bos, served[:-1]; every token
    through the und expert."""
    llm, lc = params["llm"], c["llm"]
    dev = llm["embed"].device
    parts, pos, group = [], [], []
    rope = 0
    if image is not None:
        vc = c["vit"]
        p, pid = image_patches(image, vc["patch_size"], c["vit_max_num_patch_per_side"])
        pid_t = torch.as_tensor(pid, device=dev)
        vis = siglip(params["vit"], vc, torch.as_tensor(p, device=dev).float(), pid_t)
        h = linear(F.gelu(linear(vis, params["connector"]["fc1"]), approximate="tanh"),
                   params["connector"]["fc2"])
        h = h + params["vit_pos_embed"][pid_t].float()
        blk = torch.cat([embed(llm, torch.as_tensor([ids["start_of_image"],
                                                     ids["end_of_image"]], device=dev)), h])
        parts.append(blk)
        pos.append(torch.zeros(blk.shape[0], dtype=torch.long, device=dev))
        group.append(torch.full((blk.shape[0],), -1, dtype=torch.long, device=dev))
        rope = 1
    toks = list(prompt_ids) + [ids["bos_token_id"]] + list(served[:-1])
    parts.append(embed(llm, torch.as_tensor(toks, device=dev)))
    tpos = rope + torch.arange(len(toks), device=dev)
    pos.append(tpos)
    group.append(tpos + 1_000_000)
    x = torch.cat(parts)
    gen = torch.zeros(x.shape[0], dtype=torch.bool, device=dev)
    hid = decoder(llm, lc, x, torch.cat(pos), gen, torch.cat(group))
    return logits(llm, hid[-len(served):])


# -- VAE -------------------------------------------------------------------------


def _gn(x, p):
    return F.group_norm(x, 32, p["w"].float(), p["b"].float(), 1e-6)


def _conv(x, p, padding=1, stride=1):
    return F.conv2d(x, p["w"].float(), p["b"].float(), stride=stride, padding=padding)


def _res(x, p):
    h = _conv(F.silu(_gn(x, p["norm1"])), p["conv1"])
    h = _conv(F.silu(_gn(h, p["norm2"])), p["conv2"])
    return (_conv(x, p["shortcut"], padding=0) if "shortcut" in p else x) + h


def _vae_attn(x, p):
    n, c, hh, ww = x.shape
    h = _gn(x, p["norm"])
    q, k, v = (_conv(h, p[name], padding=0).reshape(n, c, -1).transpose(1, 2)
               for name in ("q", "k", "v"))
    a = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), -1) @ v
    return x + _conv(a.transpose(1, 2).reshape(n, c, hh, ww), p["proj"], padding=0)


def vae_decode(vae: dict, c: dict, z):
    """Scaled latents [h, w, z] -> image [8h, 8w, 3] in float32 (upstream
    autoencoder.py Decoder)."""
    dec = vae["decoder"]
    z = z / c["scale_factor"] + c["shift_factor"]
    h = _conv(z.permute(2, 0, 1)[None].float(), dec["conv_in"])
    h = _res(h, dec["mid"]["block1"])
    h = _vae_attn(h, dec["mid"]["attn"])
    h = _res(h, dec["mid"]["block2"])
    for i in reversed(range(len(dec["up"]))):
        lv = dec["up"][i]
        for b in lv["blocks"]:
            h = _res(h, b)
        if "up" in lv:
            h = _conv(F.interpolate(h, scale_factor=2, mode="nearest"), lv["up"])
    h = _conv(F.silu(_gn(h, dec["norm_out"])), dec["conv_out"])
    return h[0].permute(1, 2, 0)


def to_uint8(img):
    return (torch.clamp(img * 0.5 + 0.5, 0, 1) * 255).to(torch.uint8)


def unpatchify(x, h: int, w: int, p: int, ch: int):
    """[h*w, p*p*ch] patch rows (per patch (p, q, c)) -> [h*p, w*p, ch]."""
    return x.reshape(h, w, p, p, ch).permute(0, 2, 1, 3, 4).reshape(h * p, w * p, ch)
