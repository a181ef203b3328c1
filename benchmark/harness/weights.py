"""Seeded random weights of a BAGEL configuration, made on the device.

The benchmark makes the weights itself and hands the same tensors to the
program and to the plain reference. They are laid out as the program's
parameter tree (`bagel_tpu_torch.models.bagel.init_bagel_params`: stacked
layers, `[in, out]` matrices, OIHW convolutions), drawn one leaf a call
from one `torch.Generator` on the device, in the type they are served in:
bf16 matrices, fp32 norms and VAE.

Every leaf is live, so that no part of the model can be skipped unseen:
the gen expert is drawn apart from the und expert, norm weights differ
from 1, biases from 0, and `llm2vae` is non-zero (upstream starts it at
zero, which would make every velocity the same).
"""

from __future__ import annotations

import math

import torch

STD = 0.02  # matrices, embeddings and biases
NORM_STD = 0.05  # norm weights 1 + N(0, NORM_STD), norm biases N(0, NORM_STD)


class Draw:
    """One generator on the device; each call draws one whole leaf."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) % (2**63))

    def normal(self, shape, std, dtype=torch.bfloat16, mean=0.0):
        t = torch.randn(shape, generator=self.gen, dtype=dtype, device=self.device)
        t.mul_(std)
        if mean:
            t.add_(mean)
        return t

    def norm(self, shape):
        return self.normal(shape, NORM_STD, torch.float32, mean=1.0)


def sincos_1d(dim: int, pos: torch.Tensor) -> torch.Tensor:
    omega = torch.arange(dim // 2, dtype=torch.float32, device=pos.device)
    omega = 1.0 / (10000.0 ** (omega / (dim / 2.0)))
    out = pos.reshape(-1).float()[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def sincos_2d(dim: int, side: int, device) -> torch.Tensor:
    """The frozen 2-D sin-cos table of upstream's position embeddings
    (modeling_utils.py): [side**2, dim], the column half first."""
    c = torch.arange(side, dtype=torch.float32, device=device)
    cols = c[None, :].expand(side, side).reshape(-1)
    rows = c[:, None].expand(side, side).reshape(-1)
    return torch.cat([sincos_1d(dim // 2, cols), sincos_1d(dim // 2, rows)], dim=1)


def _llm(d: Draw, c: dict, dt) -> dict:
    L, h = c["num_hidden_layers"], c["hidden_size"]
    hd = h // c["num_attention_heads"]
    qd, kvd, f = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd, c["intermediate_size"]

    def lin(d_in, d_out, bias=True):
        p = {"w": d.normal((L, d_in, d_out), STD, dt)}
        if bias:
            p["b"] = d.normal((L, d_out), STD, dt)
        return p

    layers = {}
    for sfx in ("", "_gen"):
        attn = {"q": lin(h, qd), "k": lin(h, kvd), "v": lin(h, kvd), "o": lin(qd, h, bias=False)}
        if c.get("qk_norm", True):
            attn["q_norm"] = d.norm((L, hd))
            attn["k_norm"] = d.norm((L, hd))
        layers["attn" + sfx] = attn
        layers["mlp" + sfx] = {"gate": d.normal((L, h, f), STD, dt),
                               "up": d.normal((L, h, f), STD, dt),
                               "down": d.normal((L, f, h), STD, dt)}
        layers["input_ln" + sfx] = d.norm((L, h))
        layers["post_ln" + sfx] = d.norm((L, h))
    return {"embed": d.normal((c["vocab_size"], h), STD, dt), "layers": layers,
            "final_norm": d.norm((h,)), "final_norm_gen": d.norm((h,)),
            "lm_head": {"w": d.normal((h, c["vocab_size"]), STD, dt)}}


def _dense(d: Draw, d_in, d_out, dt, std=STD):
    return {"w": d.normal((d_in, d_out), std, dt), "b": d.normal((d_out,), STD, dt)}


def _vit(d: Draw, c: dict, dt) -> dict:
    L, h, f = c["num_hidden_layers"], c["hidden_size"], c["intermediate_size"]
    patch_dim = c.get("num_channels", 3) * c["patch_size"] ** 2

    def stacked(d_in, d_out):
        return {"w": d.normal((L, d_in, d_out), STD, dt), "b": d.normal((L, d_out), STD, dt)}

    def ln(*lead):
        return {"w": d.norm(lead + (h,)), "b": d.normal(lead + (h,), NORM_STD, torch.float32)}

    return {"patch_embed": _dense(d, patch_dim, h, dt),
            "layers": {"ln1": ln(L), "ln2": ln(L),
                       "attn": {k: stacked(h, h) for k in ("q", "k", "v", "o")},
                       "mlp": {"fc1": stacked(h, f), "fc2": stacked(f, h)}},
            "post_ln": ln()}


def vae_layout(c: dict) -> dict:
    """The VAE's tree with each leaf a spec: ("conv", cout, cin, k) or
    ("gn", channels)."""
    ch, mult, nres = c["ch"], tuple(c["ch_mult"]), c["num_res_blocks"]

    def conv(cin, cout, k):
        return {"w": ("conv", cout, cin, k), "b": ("bias", cout)}

    def gn(ch_):
        return {"w": ("gn_w", ch_), "b": ("gn_b", ch_)}

    def res(cin, cout):
        p = {"norm1": gn(cin), "conv1": conv(cin, cout, 3), "norm2": gn(cout),
             "conv2": conv(cout, cout, 3)}
        if cin != cout:
            p["shortcut"] = conv(cin, cout, 1)
        return p

    def attn(ch_):
        return {"norm": gn(ch_), **{k: conv(ch_, ch_, 1) for k in ("q", "k", "v", "proj")}}

    in_mult = (1,) + mult
    levels = []
    for i, m in enumerate(mult):
        cin, cout = ch * in_mult[i], ch * m
        blocks = []
        for _ in range(nres):
            blocks.append(res(cin, cout))
            cin = cout
        level = {"blocks": blocks}
        if i != len(mult) - 1:
            level["down"] = conv(cout, cout, 3)
        levels.append(level)
    bi = ch * mult[-1]
    mid = lambda: {"block1": res(bi, bi), "attn": attn(bi), "block2": res(bi, bi)}  # noqa: E731
    enc = {"conv_in": conv(c["in_channels"], ch, 3), "levels": levels, "mid": mid(),
           "norm_out": gn(bi), "conv_out": conv(bi, 2 * c["z_channels"], 3)}
    up = []
    cin = bi
    for i in reversed(range(len(mult))):
        cout = ch * mult[i]
        blocks = []
        for _ in range(nres + 1):
            blocks.append(res(cin, cout))
            cin = cout
        level = {"blocks": blocks}
        if i != 0:
            level["up"] = conv(cout, cout, 3)
        up.insert(0, level)
    dec = {"conv_in": conv(c["z_channels"], bi, 3), "mid": mid(), "up": up,
           "norm_out": gn(cin), "conv_out": conv(cin, c["out_ch"], 3)}
    return {"encoder": enc, "decoder": dec}


def _specs(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _specs(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _specs(v, out)
    else:
        out.append(tree)


def _numel(spec):
    return spec[1] * spec[2] * spec[3] ** 2 if spec[0] == "conv" else spec[1]


def _vae(d: Draw, c: dict) -> dict:
    """All of the VAE's fp32 leaves as views of one draw (one call), each
    scaled to its kind: convolutions N(0, 1 / fan_in), biases N(0, STD),
    GroupNorm weights 1 + N(0, NORM_STD) and biases N(0, NORM_STD)."""
    layout = vae_layout(c)
    specs = []
    _specs(layout, specs)
    flat = d.normal((sum(_numel(s) for s in specs),), 1.0, torch.float32)
    at = [0]

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v) for v in tree]
        n = _numel(tree)
        t = flat[at[0]: at[0] + n]
        at[0] += n
        kind = tree[0]
        if kind == "conv":
            _, cout, cin, k = tree
            return t.mul_(1.0 / math.sqrt(cin * k * k)).view(cout, cin, k, k)
        if kind == "bias":
            return t.mul_(STD)
        if kind == "gn_w":
            return t.mul_(NORM_STD).add_(1.0)
        return t.mul_(NORM_STD)

    return build(layout)


def make_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The whole tree of a configuration file's model (`cfg`: its dict):
    llm, vit and connector, vae, the gen adapters and the frozen position
    tables, drawn in a fixed order from one generator seeded `seed`."""
    d = Draw(seed, device)
    h = cfg["llm"]["hidden_size"]
    pd = cfg["latent_patch_size"] ** 2 * cfg["vae"]["z_channels"]
    params = {"llm": _llm(d, cfg["llm"], dtype)}
    params["vit"] = _vit(d, cfg["vit"], dtype)
    params["connector"] = {"fc1": _dense(d, cfg["vit"]["hidden_size"], h, dtype),
                           "fc2": _dense(d, h, h, dtype)}
    params["vit_pos_embed"] = sincos_2d(h, cfg["vit_max_num_patch_per_side"], d.device).to(dtype)
    params["vae"] = _vae(d, cfg["vae"])
    params["time_embed"] = {"fc1": _dense(d, 256, h, dtype), "fc2": _dense(d, h, h, dtype)}
    params["vae2llm"] = _dense(d, pd, h, dtype)
    params["llm2vae"] = _dense(d, h, pd, dtype, std=h ** -0.5)
    params["latent_pos_embed"] = sincos_2d(h, cfg["max_latent_size"], d.device).to(dtype)
    return params
