"""Weight-only and weight+activation quantization for serving (port of
bagel_tpu/utils/quant.py).

Quantized leaves are dicts the models' matmul helper (`qwen2._linear`)
consumes in place of {'w'}:

- "int8":  {'w_q': int8 [in, out], 'scale': f32 [out]}, per output column,
  dequantized to the activation dtype at use;
- "w8a8":  {'w_q8', 'scale'}: the same codes, and the activations are
  quantized per token at each matmul, which then runs int8 x int8 -> int32
  (`ops.int8_matmul`). Its kernel reads the weight k-major: on the card
  `w8a8_kmajor` lays every 'w_q8' out so once, at load (the leaf keeps
  its [.., in, out] shape and values);
- "int4":  {'w_p4': uint8 [in/2, out], 'scale4': f32 [in/128, out]},
  symmetric per (128-row group, column), two nibbles a byte
  (`ops.int4_matmul` for few activation rows);
- "nf4":   {'w_nf4', 'absmax'}: the NF4 codebook, per group.

The lm_head and the embedding are always weight-only int8 (the embedding
per row: {'w_q', 'row_scale'}). Codes and scales are identical to the JAX
package's on the same float32 weights: the same float32 operations in the
same order, and round half to even.

A stacked [L, in, out] leaf is quantized one layer at a time, so that the
float32 copy (7.6 GB for one full-width stacked gate leaf) and NF4's
nearest-codebook search never exist for the whole stack at once.
"""

from __future__ import annotations

import torch

# the bitsandbytes NF4 codebook: 16 quantiles of a standard normal,
# normalized to [-1, 1] (QLoRA paper, table reproduced by value)
NF4_TABLE = torch.tensor([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], dtype=torch.float32)

GROUP = 128  # input rows per int4 / NF4 scale group
_NF4_ROWS = 512  # rows per step of the nearest-codebook search


def _per_layer(fn, w: torch.Tensor) -> dict:
    """fn over each [in, out] slice of a stacked [L, in, out] leaf, the
    results stacked on axis 0; fn(w) itself for a 2-D leaf."""
    if w.ndim == 2:
        return fn(w)
    parts = [fn(w[i]) for i in range(w.shape[0])]
    return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}


def _quantize_weight_2d(w: torch.Tensor) -> dict:
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True) / 127.0  # over the in dim
    w_q = torch.clamp(torch.round(wf / torch.clamp(scale, min=1e-12)), -127, 127)
    return {"w_q": w_q.to(torch.int8), "scale": scale.squeeze(-2)}


def quantize_weight(w: torch.Tensor) -> dict:
    """[in, out] (or [L, in, out]) float -> per-output-channel int8."""
    return _per_layer(_quantize_weight_2d, w)


def dequantize_weight(q: dict, dtype=torch.bfloat16) -> torch.Tensor:
    return (q["w_q"].float() * q["scale"][..., None, :]).to(dtype)


def maybe_dequantize(w, dtype=torch.bfloat16):
    """Passthrough for plain tensors; an int8 weight-only dict dequantizes."""
    if isinstance(w, dict) and "w_q" in w:
        return dequantize_weight(w, dtype)
    return w


def _pack_nibbles(idx: torch.Tensor) -> torch.Tensor:
    """uint8 values 0..15 over [..., in, out] -> [..., in/2, out] packed
    (row 2i -> low nibble, row 2i+1 -> high)."""
    return (idx[..., 0::2, :] | (idx[..., 1::2, :] << 4)).to(torch.uint8)


def _unpack_nibbles(p4: torch.Tensor) -> torch.Tensor:
    """Inverse of _pack_nibbles: [..., in/2, out] -> [..., in, out] uint8."""
    stacked = torch.stack([p4 & 15, p4 >> 4], dim=-2)  # [..., in/2, 2, out]
    return stacked.reshape(p4.shape[:-2] + (p4.shape[-2] * 2, p4.shape[-1]))


def _groups(wf: torch.Tensor, group: int):
    in_ = wf.shape[-2]
    group = min(group, in_)  # small test configs: one group per column
    assert in_ % group == 0 and in_ % 2 == 0, (in_, group)
    return wf.reshape(wf.shape[:-2] + (in_ // group, group, wf.shape[-1]))


def quantize_weight_int4(w: torch.Tensor, group: int = GROUP) -> dict:
    """[in, out] (or [L, in, out]) -> symmetric int4, per-(group, column)
    scales. in % (2, group) == 0."""

    def one(w2):
        wf = w2.float()
        wg = _groups(wf, group)
        scale = torch.clamp(wg.abs().amax(dim=-2, keepdim=True) / 7.0, min=1e-12)
        q = torch.clamp(torch.round(wg / scale), -8, 7).reshape(wf.shape)
        return {"w_p4": _pack_nibbles((q + 8).to(torch.uint8)),
                "scale4": scale.squeeze(-2)}

    return _per_layer(one, w)


def quantize_weight_nf4(w: torch.Tensor, group: int = GROUP) -> dict:
    """[in, out] (or stacked) -> NF4 codebook indices + per-group absmax."""

    def one(w2):
        wf = w2.float()
        wg = _groups(wf, group)
        absmax = torch.clamp(wg.abs().amax(dim=-2, keepdim=True), min=1e-12)
        normed = (wg / absmax).reshape(wf.shape)
        table = NF4_TABLE.to(wf.device)
        # nearest codebook entry (argmin keeps the first of equal distances,
        # as jnp.argmin does), a block of rows at a time
        idx = torch.cat([
            (normed[r:r + _NF4_ROWS, :, None] - table).abs().argmin(dim=-1)
            for r in range(0, normed.shape[0], _NF4_ROWS)
        ]).to(torch.uint8)
        return {"w_nf4": _pack_nibbles(idx), "absmax": absmax.squeeze(-2)}

    return _per_layer(one, w)


def dequantize_weight4(q: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize an int4/NF4 leaf back to [..., in, out]."""
    if "w_p4" in q:
        w = (_unpack_nibbles(q["w_p4"]).to(torch.int8) - 8).float()
        scale = q["scale4"]
    else:
        w = NF4_TABLE.to(q["w_nf4"].device)[_unpack_nibbles(q["w_nf4"]).long()]
        scale = q["absmax"]
    in_ = w.shape[-2]
    group = in_ // scale.shape[-2]
    w = w.reshape(w.shape[:-2] + (in_ // group, group, w.shape[-1])) * scale[..., :, None, :]
    return w.reshape(w.shape[:-3] + (in_, w.shape[-1])).to(dtype)


def _quantize_weight_a8(w: torch.Tensor) -> dict:
    q = quantize_weight(w)
    return {"w_q8": q["w_q"], "scale": q["scale"]}


def is_kmajor(w: torch.Tensor) -> bool:
    """Whether [..., K, N] w is a transposed view of a contiguous [..., N, K]
    tensor (k contiguous)."""
    return w.ndim >= 2 and w.transpose(-1, -2).is_contiguous()


def to_kmajor(w: torch.Tensor) -> torch.Tensor:
    """The same [..., K, N] values laid out k-major (`is_kmajor`), the
    layout B5's wgmma reads (it takes 8-bit operands only K-major); w itself
    if it already is."""
    return w if is_kmajor(w) else w.transpose(-1, -2).contiguous().transpose(-1, -2)


def w8a8_kmajor(tree: dict) -> dict:
    """Make every w8a8 weight ('w_q8') of a params tree k-major (`to_kmajor`),
    in place, one leaf at a time: peak memory grows by one stacked leaf,
    since each row-major leaf is dropped as its copy replaces it (unless the
    caller holds it elsewhere). Shapes and values are unchanged; idempotent.
    Call it after `qwen2.fuse_llm_params` (fusion also keeps k-major leaves
    k-major). Returns the tree."""
    for key, val in tree.items():
        if key == "w_q8" and torch.is_tensor(val):
            tree[key] = to_kmajor(val)
            del val
        elif isinstance(val, dict):
            w8a8_kmajor(val)
    return tree


_QUANT = {
    "int8": quantize_weight,
    "w8a8": _quantize_weight_a8,
    "int4": quantize_weight_int4,
    "nf4": quantize_weight_nf4,
}


def quantize_embedding(emb: torch.Tensor) -> dict:
    """[vocab, d] -> int8 rows with one f32 scale per row."""
    out_q = torch.empty(emb.shape, dtype=torch.int8, device=emb.device)
    out_s = torch.empty(emb.shape[0], dtype=torch.float32, device=emb.device)
    step = 16384  # rows at a time: the f32 copy of a full vocabulary is 2.2 GB
    for r in range(0, emb.shape[0], step):
        e = emb[r:r + step].float()
        scale = torch.clamp(e.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
        out_q[r:r + step] = torch.clamp(torch.round(e / scale), -127, 127).to(torch.int8)
        out_s[r:r + step] = scale[:, 0]
    return {"w_q": out_q, "row_scale": out_s}


def quantize_llm_params(params: dict, mode: str = "int8") -> dict:
    """Quantize the LLM's large matmuls (attention projections, FFN,
    lm_head, embedding). Norms, biases and adapters stay as they are, and
    the input tree is not modified.

    mode: "int8" per column, "w8a8" per-column weights + dynamic per-token
    int8 activations, "int4" per-group symmetric, "nf4" per-group codebook.
    The lm_head and embedding always use weight-only int8."""
    assert mode in _QUANT, mode
    quant = _QUANT[mode]
    out = dict(params)
    layers = dict(params["layers"])
    for name in list(layers):
        if name.startswith("attn"):
            a = dict(layers[name])
            for k in ("q", "k", "v", "o"):
                p = dict(a[k])
                p.update(quant(p.pop("w")))
                a[k] = p
            layers[name] = a
        elif name.startswith("mlp"):
            layers[name] = {k: quant(v) for k, v in layers[name].items()}
    out["layers"] = layers
    out["lm_head"] = quantize_weight(params["lm_head"]["w"])
    out["embed"] = quantize_embedding(params["embed"])
    return out


def quantize_bagel_params(params: dict, mode: str = "int8") -> dict:
    out = dict(params)
    out["llm"] = quantize_llm_params(params["llm"], mode)
    return out
