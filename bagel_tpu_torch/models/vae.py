"""FLUX-style conv VAE (port of bagel_tpu/models/vae.py).

Pure functions over the JAX parameter tree, with one layout change: conv
kernels are OIHW here (HWIO in JAX; utils/bridge.py converts). Inside, the
VAE runs NCHW with F.conv2d; `vae_encode` and `vae_decode` take and return
NHWC, the JAX layout. The mid-block attention is a plain matmul + softmax,
as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bagel_tpu_torch.configs import VAEConfig
from bagel_tpu_torch.ops.norms import group_norm_nchw
from bagel_tpu_torch.utils.device import resolve_device


def swish(x):
    return x * torch.sigmoid(x)


def conv2d(x, p, stride=1, padding=1):
    """NCHW conv with an OIHW kernel (the VAE runs in fp32 throughout)."""
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=padding)


def _conv_init(generator, kh, kw, cin, cout, dtype, device):
    fan_in = kh * kw * cin
    w = torch.randn((cout, cin, kh, kw), generator=generator,
                    dtype=torch.float32, device=device) * (fan_in**-0.5)
    return {"w": w.to(dtype), "b": torch.zeros((cout,), dtype=torch.float32, device=device)}


def _gn_init(c, device):
    return {"w": torch.ones((c,), dtype=torch.float32, device=device),
            "b": torch.zeros((c,), dtype=torch.float32, device=device)}


def _resnet_init(generator, cin, cout, dtype, device):
    p = {
        "norm1": _gn_init(cin, device),
        "conv1": _conv_init(generator, 3, 3, cin, cout, dtype, device),
        "norm2": _gn_init(cout, device),
        "conv2": _conv_init(generator, 3, 3, cout, cout, dtype, device),
    }
    if cin != cout:
        p["shortcut"] = _conv_init(generator, 1, 1, cin, cout, dtype, device)
    return p


def _resnet_apply(x, p):
    h = group_norm_nchw(x, p["norm1"]["w"], p["norm1"]["b"])
    h = conv2d(swish(h), p["conv1"], padding=1)
    h = group_norm_nchw(h, p["norm2"]["w"], p["norm2"]["b"])
    h = conv2d(swish(h), p["conv2"], padding=1)
    if "shortcut" in p:
        x = conv2d(x, p["shortcut"], padding=0)
    return x + h


def _attn_init(generator, c, dtype, device):
    return {
        "norm": _gn_init(c, device),
        **{name: _conv_init(generator, 1, 1, c, c, dtype, device)
           for name in ("q", "k", "v", "proj")},
    }


def _attn_apply(x, p):
    """Single-head full attention over the spatial grid (upstream
    autoencoder.py:38-65): fp32 logits and softmax, probabilities cast to
    v's dtype."""
    n, c, hh, ww = x.shape
    h = group_norm_nchw(x, p["norm"]["w"], p["norm"]["b"])

    def tokens(name):  # [n, hw, c]
        return conv2d(h, p[name], padding=0).reshape(n, c, hh * ww).transpose(1, 2)

    q, k, v = tokens("q"), tokens("k"), tokens("v")
    logits = torch.bmm(q.float(), k.float().transpose(1, 2)) * (c**-0.5)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    del logits
    att = torch.bmm(probs.float(), v.float()).to(x.dtype)
    att = att.transpose(1, 2).reshape(n, c, hh, ww)
    return x + conv2d(att, p["proj"], padding=0)


def init_vae_params(generator, cfg: VAEConfig, dtype=torch.float32, device=None) -> dict:
    device = resolve_device(device)
    g, dt, dev = generator, dtype, device
    ch = cfg.ch
    in_mult = (1,) + tuple(cfg.ch_mult)

    enc = {"conv_in": _conv_init(g, 3, 3, cfg.in_channels, ch, dt, dev)}
    levels = []
    for i, mult in enumerate(cfg.ch_mult):
        cin, cout = ch * in_mult[i], ch * mult
        blocks = []
        for _ in range(cfg.num_res_blocks):
            blocks.append(_resnet_init(g, cin, cout, dt, dev))
            cin = cout
        level = {"blocks": blocks}
        if i != len(cfg.ch_mult) - 1:
            level["down"] = _conv_init(g, 3, 3, cout, cout, dt, dev)
        levels.append(level)
    block_in = ch * cfg.ch_mult[-1]
    enc.update(
        levels=levels,
        mid={
            "block1": _resnet_init(g, block_in, block_in, dt, dev),
            "attn": _attn_init(g, block_in, dt, dev),
            "block2": _resnet_init(g, block_in, block_in, dt, dev),
        },
        norm_out=_gn_init(block_in, dev),
        conv_out=_conv_init(g, 3, 3, block_in, 2 * cfg.z_channels, dt, dev),
    )

    dec = {"conv_in": _conv_init(g, 3, 3, cfg.z_channels, block_in, dt, dev)}
    dec["mid"] = {
        "block1": _resnet_init(g, block_in, block_in, dt, dev),
        "attn": _attn_init(g, block_in, dt, dev),
        "block2": _resnet_init(g, block_in, block_in, dt, dev),
    }
    up_levels = []
    cin = block_in
    for i in reversed(range(len(cfg.ch_mult))):
        cout = ch * cfg.ch_mult[i]
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(_resnet_init(g, cin, cout, dt, dev))
            cin = cout
        level = {"blocks": blocks}
        if i != 0:
            level["up"] = _conv_init(g, 3, 3, cout, cout, dt, dev)
        up_levels.insert(0, level)
    dec.update(
        up=up_levels,
        norm_out=_gn_init(cin, dev),
        conv_out=_conv_init(g, 3, 3, cin, cfg.out_ch, dt, dev),
    )
    return {"encoder": enc, "decoder": dec}


def _posterior_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """The standard normal draw of the posterior sample, NHWC. JAX draws
    it with jax.random.normal from a PRNGKey, so the two differ on the same
    seed; tests hand this function JAX's draw."""
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)


def vae_encode(
    params: dict,
    cfg: VAEConfig,
    images: torch.Tensor,  # [N, H, W, 3] in [-1, 1]
    generator: Optional[torch.Generator] = None,
    sample: bool = True,
) -> torch.Tensor:
    """Images -> scaled latents [N, H/f, W/f, z_channels] (NHWC), f the
    encoder's downsampling: the diagonal Gaussian posterior's sample (from
    `generator`, by default one seeded 0 on the images' device) or, with
    sample=False, its mean; then scale_factor * (z - shift_factor)
    (upstream AutoEncoder.encode, autoencoder.py:315-318)."""
    enc = params["encoder"]
    h = conv2d(images.permute(0, 3, 1, 2), enc["conv_in"], padding=1)
    for level in enc["levels"]:
        for block in level["blocks"]:
            h = _resnet_apply(h, block)
        if "down" in level:  # asymmetric padding: one row and column at the end
            h = conv2d(F.pad(h, (0, 1, 0, 1)), level["down"], stride=2, padding=0)
    h = _resnet_apply(h, enc["mid"]["block1"])
    h = _attn_apply(h, enc["mid"]["attn"])
    h = _resnet_apply(h, enc["mid"]["block2"])
    h = group_norm_nchw(h, enc["norm_out"]["w"], enc["norm_out"]["b"])
    h = conv2d(swish(h), enc["conv_out"], padding=1)

    mean, logvar = h.permute(0, 2, 3, 1).chunk(2, dim=-1)
    if sample:
        if generator is None:
            generator = torch.Generator(device=images.device).manual_seed(0)
        z = mean + torch.exp(0.5 * logvar) * _posterior_noise(
            mean.shape, generator, images.device)
    else:
        z = mean
    return cfg.scale_factor * (z - cfg.shift_factor)


def vae_decode(params: dict, cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """Scaled latents [N, h, w, z] -> images [N, 8h, 8w, 3] (NHWC)."""
    z = z / cfg.scale_factor + cfg.shift_factor
    dec = params["decoder"]
    h = conv2d(z.permute(0, 3, 1, 2), dec["conv_in"], padding=1)
    h = _resnet_apply(h, dec["mid"]["block1"])
    h = _attn_apply(h, dec["mid"]["attn"])
    h = _resnet_apply(h, dec["mid"]["block2"])
    for i in reversed(range(len(dec["up"]))):
        level = dec["up"][i]
        for block in level["blocks"]:
            h = _resnet_apply(h, block)
        if "up" in level:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = conv2d(h, level["up"], padding=1)
    h = group_norm_nchw(h, dec["norm_out"]["w"], dec["norm_out"]["b"])
    h = conv2d(swish(h), dec["conv_out"], padding=1)
    return h.permute(0, 2, 3, 1)
