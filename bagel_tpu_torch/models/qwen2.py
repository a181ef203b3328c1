"""Qwen2 Mixture-of-Transformer-experts (MoT) decoder, inference half
(port of bagel_tpu/models/qwen2.py).

- Parameters keep the JAX tree: per-layer weights stacked on axis 0,
  `[in, out]` matrices, fused (`qkv`, `gate_up`) or separate leaves. The
  `lax.scan` over layers becomes a Python loop over `layers[...][i]`.
- The KV cache is a preallocated buffer `[L, B, S, KH, D]` with a per-row
  length. Writes are out of place, as in JAX: `llm_extend` never mutates the
  cache it is given. With `update_cache=True` it returns a new buffer; with
  `update_cache=False` each layer writes the block into a clone of the live
  prefix of its slice that is dropped after the attention. So contexts may
  share buffers (`GenContext.copy()`), exactly as JAX arrays do. The
  exception is the port's own: a caller that owns its cache passes
  `in_place=True` (where JAX donates the buffer), and the block's K/V are
  written into it. `decode_text` copies its context's cache into its
  decode program's own buffer and writes every token there in place; with
  `in_place=True` (the serving runtime's slot cache, `chat_batch`) it
  writes into the given cache.
- `decode_text` is JAX's compiled decode loop as chunks of `decode_step`
  on static tensors (`DecodeState`), each chunk one CUDA-graph replay of
  an `inference.decode_program.DecodeProgram` on CUDA tensors.
- The int8 KV cache (`kv_cache_init(dtype=torch.int8)`, JAX's `kv_quant`):
  codes `[L, B, S, KH, D]` and f32 scales `[L, B, S, KH]` per (token, KV
  head), `_kv_quantize`'s symmetric rounding. A block is quantized and
  written first, then read back: a decode step (T = 1) through
  `ops.flash.flash_decode_kv8`, whose kernel reads the codes; a longer block
  through the bf16 attention over the live prefix dequantized once a layer
  (JAX's design for its Pallas path). The working dtype is then bf16.
- MoT expert selection is by token position: tokens [0, und_len) use the
  und expert, the rest the gen expert, each running only its own matmuls.
- On a CUDA tensor with attn_impl="auto" every attention goes through the
  hand-written kernel (`ops.flash.flash_cached_attention`), prefill (causal)
  and denoise (non-causal) alike; any attn_impl other than "auto"/"flash"
  takes the plain version (`flash_cached_attention_plain`). Decode steps
  (T=1) go through the same kernel. With `BAGEL_FLASH_INT8=1` every block of
  more than one token (prefill, ViT block, gen block) takes the int8
  attention, as on the JAX package's TPU path; decode steps stay bf16.
- Where the attention takes the kernels and the activations are bf16
  (`_fused`), each layer is `_layer_extend_fused`: the elementwise passes
  between its GEMMs are the hand-written kernels of
  `ops.layer_elementwise` (the residual add with the next RMSNorm, the
  fp32 QK-norm with rope and the K/V write, SiLU x up), at the plain
  path's rounding points, each reading the MoT split by row, so the layer
  has no cat of the experts' rows and no copy of a strided slice. Every
  other block (fp32, attn_impl "plain", CPU tensors under "auto") takes
  `_layer_extend`.
- Quantized weight leaves (`utils.quant`): `w_q` (int8 weight-only) and
  `w_nf4` dequantize to the activation dtype at use; `w_q8` (w8a8) quantizes
  the activations per token and runs `ops.int8_matmul`; `w_p4` (int4) runs
  `ops.int4_matmul` for at most 64 activation rows on CUDA (decode) and
  dequantizes otherwise, as the JAX package does.
- Sharded inference (`layout=`, a `parallel.mesh.InferenceLayout`): the
  params hold this process's shards. Each layer gathers its fsdp shards at
  use and runs Megatron tp over its local heads and FFN columns (the
  cache holds the local KV heads, `kv_cache_init(layout=)`), with one
  all-reduce after o and one after down, through `_layer_extend`'s `tp`,
  the hook `train_layer_block` takes (a w8a8 o or down adds one before:
  its activation rows' absmax, MAX over tp, so that each row is quantized
  with its whole row's scale, as JAX's); the embedding is a vocab-parallel
  lookup summed over tp, the logits this rank's part of the vocabulary
  all-gathered over tp.

Training (`llm_forward_train`): the packed multi-sample forward of the MoT
stack over one sequence, with its four attention choices (a dense [S, S]
mask, `attn_chunk`, `sparse_block` through the block-sparse kernel with its
gradient, `context_parallel`: ring attention over a process group), the
sharded layouts of `parallel.mesh` (`layout=`), per-layer
activation checkpointing (`remat`) and `freeze_und`. Each expert runs over
its own tokens only (gathered by index and merged back, the reference's
formulation, qwen2_navit.py:713-755), where JAX runs both experts over every
token and selects; the values per token are the same, at half the
projection and FFN products. `freeze_und` detaches the und tokens'
contributions at JAX's points.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from bagel_tpu_torch.configs import Qwen2Config
from bagel_tpu_torch.ops import flash
from bagel_tpu_torch.ops.attention import dot_attention
from bagel_tpu_torch.ops.chunked import chunked_packed_attention
from bagel_tpu_torch.ops.flash import (
    flash_cached_attention,
    flash_cached_attention_plain,
    flash_decode_kv8,
    flash_decode_kv8_plain,
)
from bagel_tpu_torch.ops.flash import kv_dequantize as _kv_dequantize
from bagel_tpu_torch.ops.int4_matmul import int4_gemv_eligible, int4_matmul
from bagel_tpu_torch.ops.int8_matmul import int8_matmul, quantize_rows, row_absmax, row_scale
from bagel_tpu_torch.ops.layer_elementwise import (
    Split,
    add_rms_norm,
    add_rms_norm_plain,
    qk_norm_rope,
    qk_norm_rope_f32,
    qk_norm_rope_plain,
    silu_mul,
)
from bagel_tpu_torch.ops.layer_elementwise import block_slots as _block_at
from bagel_tpu_torch.ops.layer_elementwise import split_apply as _split_apply
from bagel_tpu_torch.ops.norms import rms_norm
from bagel_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from bagel_tpu_torch.ops.ring import ring_packed_attention
from bagel_tpu_torch.ops.sparse_flash import kernel_tables, sparse_packed_attention_train
from bagel_tpu_torch.parallel.mesh import gather_seq, split_seq
from bagel_tpu_torch.utils.device import resolve_device
from bagel_tpu_torch.utils.quant import dequantize_weight4, is_kmajor


@dataclasses.dataclass
class KVCache:
    """Append-only KV buffer. k/v: [L, B, S_max, KH, D]; length: [B] int32.

    The int8 variant (kv_cache_init with dtype=torch.int8): k/v hold int8
    codes and k_scale/v_scale the per-(token, head) f32 scales
    [L, B, S_max, KH], half the bytes of a bf16 cache."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    def buffers(self) -> tuple:
        """(k, v, k_scale, v_scale); the scales are None for a bf16 cache."""
        return self.k, self.v, self.k_scale, self.v_scale

    def clone(self) -> "KVCache":
        k, v, ks, vs = (None if t is None else t.clone() for t in self.buffers())
        return KVCache(k=k, v=v, length=self.length.clone(), k_scale=ks, v_scale=vs)


def kv_cache_init(
    cfg: Qwen2Config, batch: int, max_len: int, dtype=torch.bfloat16,
    device=None, layout=None,
) -> KVCache:
    """A zeroed cache of `batch` rows; under `layout` with this process's
    KV heads."""
    device = resolve_device(device)
    kv_heads = cfg.num_key_value_heads if layout is None else layout.kv_heads
    shape = (cfg.num_hidden_layers, batch, max_len, kv_heads, cfg.head_dim)

    def scales():  # an int8 cache's f32 scales, one per (token, KV head)
        if dtype != torch.int8:
            return None
        return torch.zeros(shape[:-1], dtype=torch.float32, device=device)

    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
        k_scale=scales(),
        v_scale=scales(),
    )


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8: [..., D] -> (codes, f32 scales[...]).
    torch.round rounds half to even, as jnp.round does."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------


def _normal(generator, shape, std, dtype, device):
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return w.mul_(std).to(dtype)


def init_qwen2_params(
    generator: torch.Generator, cfg: Qwen2Config, dtype=torch.bfloat16,
    device=None, place=None,
) -> dict:
    """Random-init parameter tree with per-layer weights stacked on axis 0.

    Gen-expert weights start as copies of the und weights and every norm
    weight as 1, mirroring upstream init_moe. `generator` must live on
    `device`. `place(path, leaf)` ('/'-joined path in this tree) takes each
    leaf as soon as it is drawn and returns what the tree keeps (a
    process's shard under a mesh): the whole tree is never held at once.
    """
    device = resolve_device(device)
    L = cfg.num_hidden_layers
    d = cfg.hidden_size
    hd = cfg.head_dim
    qd = cfg.num_attention_heads * hd
    kvd = cfg.num_key_value_heads * hd
    f = cfg.intermediate_size
    g, dt, dev = generator, dtype, device
    mot = cfg.layer_module == "mot"
    put = place or (lambda path, t: t)
    twins = {"attn": mot, "mlp": cfg.use_moe, "input_ln": mot, "post_ln": mot}
    gen_copies = {}

    def layer_leaf(path, t):
        """The stacked leaf layers/<path>, and its gen expert's copy."""
        top, _, rest = path.partition("/")
        if twins[top]:
            twin = f"{top}_gen/{rest}" if rest else f"{top}_gen"
            gen_copies[twin] = put(f"layers/{twin}", t.clone())
        return put(f"layers/{path}", t)

    def dense(path, d_in, d_out, bias=True):
        p = {"w": layer_leaf(f"{path}/w", _normal(g, (L, d_in, d_out), 0.02, dt, dev))}
        if bias:
            p["b"] = layer_leaf(f"{path}/b", torch.zeros((L, d_out), dtype=dt, device=dev))
        return p

    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=dev)  # noqa: E731
    attn = {"q": dense("attn/q", d, qd), "k": dense("attn/k", d, kvd),
            "v": dense("attn/v", d, kvd), "o": dense("attn/o", qd, d, bias=False)}
    if cfg.qk_norm:
        attn["q_norm"] = layer_leaf("attn/q_norm", ones(L, hd))
        attn["k_norm"] = layer_leaf("attn/k_norm", ones(L, hd))
    mlp = {name: layer_leaf(f"mlp/{name}", _normal(g, shape, 0.02, dt, dev))
           for name, shape in (("gate", (L, d, f)), ("up", (L, d, f)), ("down", (L, f, d)))}
    layers = {"attn": attn, "mlp": mlp, "input_ln": layer_leaf("input_ln", ones(L, d)),
              "post_ln": layer_leaf("post_ln", ones(L, d))}
    for path, t in gen_copies.items():
        *parents, leaf = path.split("/")
        node = layers
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t

    params = {
        "embed": put("embed", _normal(g, (cfg.vocab_size, d), 0.02, dt, dev)),
        "layers": layers,
        "final_norm": put("final_norm", ones(d)),
        "lm_head": {"w": put("lm_head/w", _normal(g, (d, cfg.vocab_size), 0.02, dt, dev))},
    }
    if cfg.use_moe:
        params["final_norm_gen"] = put("final_norm_gen", ones(d))
    return params


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in fp32, as JAX's preferred_element_type=f32 product: on CUDA
    a bf16 x bf16 product with f32 accumulation and f32 output
    (`torch.mm(..., out_dtype=torch.float32)`), with no f32 copy of the
    weight; elsewhere (this op has no CPU kernel) the inputs upcast."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(x.shape[:-1] + (w.shape[-1],))
    return torch.matmul(x.float(), w.float())


def quantize_activations(x2: torch.Tensor, tp=None):
    """w8a8's (codes, scales [M, 1]) of the activation rows x2 [M, K]: each
    row with its own scale, or, for a row-parallel leaf (`tp`, an
    `InferenceTP` of n > 1, whose input rows this rank holds a slice of),
    with the whole row's: the slice's absmax all-reduced with MAX over tp,
    then the scale and the codes of the slice, as JAX's max over the
    sharded axis. Per-token scales alone need this: the int8 KV cache's are
    per (token, KV head) and heads split whole over tp; weight-only int8,
    int4 and NF4 scales are per column or group and follow their weight's
    split."""
    if tp is None:
        return quantize_rows(x2)
    return quantize_rows(x2, row_scale(tp.row_max(row_absmax(x2))))


def _linear(x: torch.Tensor, p, width: Optional[int] = None, tp=None) -> torch.Tensor:
    """x @ w (+ b) over a weight leaf: {'w'[, 'b']}, a bare tensor, or a
    quantized dict (`utils.quant`; see the module docstring). `width`: the
    whole leaf's output width where `p` is a tp shard of its columns (B4's
    eligibility reads the whole leaf, as JAX's rule does). `tp`: the
    `InferenceTP` (n > 1) of a row-parallel leaf, whose input rows this rank
    holds a slice of: the product of the bias-free leaf is then this rank's
    partial sum in fp32, not rounded (rounded once after the all-reduce, as
    JAX rounds the whole sum; B5 writes it unrounded too, B4 writes bf16, so
    its partial sums are rounded once before), and a w8a8 leaf quantizes
    each row with the whole row's scale (`quantize_activations`).

    The bias is added in fp32 before the one rounding to x.dtype, as the
    JAX `preferred_element_type=f32` product does: in the matmul's epilogue
    (torch.addmm) for a plain or dequantized weight, in the kernel's for
    w8a8; after the kernel's bf16 result for int4, as JAX does (in the
    kernel's epilogue for bf16 activations)."""
    if not isinstance(p, dict):
        p = {"w": p}
    lead = x.shape[:-1]
    f32 = tp is not None
    if "w_q8" in p:
        xq, xs = quantize_activations(x.reshape(-1, x.shape[-1]), tp)
        out = int8_matmul(xq, xs, p["w_q8"], p["scale"], p.get("b"),
                          out_dtype=torch.float32 if f32 else x.dtype)
        return out.reshape(lead + (out.shape[-1],))
    if "w_p4" in p:
        rows = math.prod(lead)
        if int4_gemv_eligible(rows, p, x.device, out=width):
            # bandwidth-bound decode: the kernel reads the packed nibbles
            # once instead of a dequantized weight in device memory
            x2 = x.reshape(rows, x.shape[-1])
            if x.dtype == torch.bfloat16:  # one launch: the bias in the epilogue
                out = int4_matmul(x2, p["w_p4"], p["scale4"], p.get("b"))
                out = out.float() if f32 else out
            else:
                out = int4_matmul(x2, p["w_p4"], p["scale4"]).float()
                if "b" in p:
                    out = out + p["b"].float()
                out = out if f32 else out.to(x.dtype)
            return out.reshape(lead + (out.shape[-1],))
    if "w_q" in p:
        w = (p["w_q"].float() * p["scale"][..., None, :]).to(x.dtype)
    elif "w_p4" in p or "w_nf4" in p:
        w = dequantize_weight4(p, x.dtype)
    else:
        w = p["w"]
    if f32:
        return _matmul_f32(x, w)
    if "b" not in p:
        return torch.matmul(x, w)
    if p["b"].dtype != x.dtype:  # e.g. f32 biases beside a quantized embedding's bf16
        return (torch.matmul(x, w).float() + p["b"].float()).to(x.dtype)
    out = torch.addmm(p["b"], x.reshape(-1, x.shape[-1]), w)
    return out.reshape(lead + (w.shape[-1],))


# ---------------------------------------------------------------------------
# Fused projections: one [d, qd+2*kvd] QKV matmul and one [d, 2f] gate-up
# matmul per expert instead of 3+2 (in w8a8 one activation quantization per
# group). Every weight, scale and bias leaf has the output dim last, so the
# fusion commutes with every quantization mode.
# ---------------------------------------------------------------------------


def _concat_leaves(leaves: list) -> dict:
    """Concat matching weight-dict leaves along the output (last) axis; k-major
    w8a8 weights (`utils.quant.w8a8_kmajor`) stay k-major."""
    keys = set(leaves[0])
    assert all(set(p) == keys for p in leaves), "heterogeneous leaves"

    def cat(k):
        ts = [p[k] for p in leaves]
        if k == "w_q8" and all(is_kmajor(t) for t in ts):
            return torch.cat([t.transpose(-1, -2) for t in ts], dim=-2).transpose(-1, -2)
        return torch.cat(ts, dim=-1)

    return {k: cat(k) for k in keys}


def fuse_llm_params(params: dict, inplace: bool = False) -> dict:
    """Return params with per-attn 'qkv' and per-mlp 'gate_up' fused leaves
    (originals dropped). Idempotent; leaves bare norms/lm_head untouched.

    inplace=True mutates the given dicts so that each group's unfused
    leaves are freed as soon as its fused leaf exists: peak memory is one
    extra group, not a second tree. Callers that keep references to the
    original tree must use inplace=False."""
    out = params if inplace else dict(params)
    layers = params["layers"] if inplace else dict(params["layers"])
    for name in list(layers):
        if name.startswith("attn"):
            a = layers[name] if inplace else dict(layers[name])
            if "qkv" not in a:
                q, k, v = a.pop("q"), a.pop("k"), a.pop("v")
                a["qkv"] = _concat_leaves([q, k, v])
                del q, k, v
            layers[name] = a
        elif name.startswith("mlp"):
            m = layers[name] if inplace else dict(layers[name])
            if "gate_up" not in m:
                gate, up = m.pop("gate"), m.pop("up")
                if not isinstance(gate, dict):
                    gate, up = {"w": gate}, {"w": up}
                m["gate_up"] = _concat_leaves([gate, up])
                del gate, up
            layers[name] = m
    out["layers"] = layers
    return out


def _proj_qkv(x, attn, h, kh, hd, widths=None):
    """(q, k, v) heads from either fused or separate projection leaves
    (`widths`: the whole leaves' output widths of tp shards, by name)."""
    lead = x.shape[:-1]
    w = widths or {}
    if "qkv" in attn:
        qkv = _linear(x, attn["qkv"], w.get("qkv"))
        q, k, v = torch.split(qkv, [h * hd, kh * hd, kh * hd], dim=-1)
    else:
        q = _linear(x, attn["q"], w.get("q"))
        k = _linear(x, attn["k"], w.get("k"))
        v = _linear(x, attn["v"], w.get("v"))
    return (q.reshape(lead + (h, hd)), k.reshape(lead + (kh, hd)),
            v.reshape(lead + (kh, hd)))


def _gate_up(z, mlp, widths=None):
    """(gate, up) from fused or separate gate/up leaves."""
    w = widths or {}
    if "gate_up" in mlp:
        return _linear(z, mlp["gate_up"], w.get("gate_up")).chunk(2, dim=-1)
    return _linear(z, mlp["gate"], w.get("gate")), _linear(z, mlp["up"], w.get("up"))


def _ffn_mix(z, mlp, widths=None):
    """silu(gate) * up from fused or separate gate/up leaves."""
    gate, up = _gate_up(z, mlp, widths)
    return F.silu(gate) * up


# ---------------------------------------------------------------------------
# Layer forward (inference, block-extend over the KV cache)
# ---------------------------------------------------------------------------


def _layer_params(layers: dict, i: int) -> dict:
    """Layer i's slice of the stacked parameter tree."""
    if isinstance(layers, dict):
        return {k: _layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def _rope_into_cache(cfg, und_len, q, k, v, attn_u, attn_g, cos, sin, k_buf, v_buf,
                     ks_buf, vs_buf, past_len) -> torch.Tensor:
    """The fp32 QK-norm and rope of the block's q and k [B, T, heads, D],
    its K/V written into the buffers at [past_len, past_len + T) (an int8
    cache: codes quantized from the f32 k, and their scales); returns q in
    the attention's dtype."""
    eps = cfg.rms_norm_eps
    qk = [(attn_u[n], attn_g[n]) if cfg.qk_norm else None for n in ("q_norm", "k_norm")]
    if k_buf.dtype != torch.int8:
        return qk_norm_rope_plain(*(Split.block(z, und_len) for z in (q, k, v)), *qk, cos, sin,
                                  k_buf, v_buf, past_len, eps)
    q, k = qk_norm_rope_f32(q, k, und_len, *qk, cos, sin, eps)
    # append the block at per-row offsets, one indexed write a buffer;
    # quantize first, then attend over the cache's codes
    rows, at = _block_at(past_len, q.shape[1], k_buf.shape[1])
    (k, ks), (v, vs) = _kv_quantize(k), _kv_quantize(v)
    ks_buf[rows, at] = ks
    vs_buf[rows, at] = vs
    k_buf[rows, at] = k.to(k_buf.dtype)
    v_buf[rows, at] = v.to(v_buf.dtype)
    return q.to(torch.bfloat16)


def _attend(q, k_buf, v_buf, ks_buf, vs_buf, past_len, live, q_valid, causal, kernel):
    """The block's attention over the buffers, through the kernels (B1,
    B1-kv8, B2) or their plain versions."""
    t = q.shape[1]
    quant = k_buf.dtype == torch.int8
    cdt = torch.bfloat16 if quant else k_buf.dtype
    if quant and t == 1:
        # the decode step reads the codes themselves (B1-kv8)
        decode = flash_decode_kv8 if kernel else flash_decode_kv8_plain
        att = decode(q, k_buf, v_buf, ks_buf, vs_buf, past_len, q_valid)
    else:
        k_use, v_use = k_buf, v_buf
        if quant:  # the live prefix, dequantized once for the layer
            k_use = _kv_dequantize(k_buf[:, :live], ks_buf[:, :live], cdt)
            v_use = _kv_dequantize(v_buf[:, :live], vs_buf[:, :live], cdt)
        # the JAX package sends every block of more than one token to its
        # flash kernel on the TPU, and so to the int8 one under
        # BAGEL_FLASH_INT8
        int8 = t > 1 and flash.default_int8()
        attend = flash_cached_attention if kernel else flash_cached_attention_plain
        att = attend(q, k_use, v_use, past_len, q_valid, causal=causal, int8_compute=int8)
    return att


def _layer_extend(
    cfg: Qwen2Config,
    und_len: int,
    causal: bool,
    x: torch.Tensor,  # [B, T, d]
    lp: dict,  # one layer's params
    k_buf: torch.Tensor,  # [B, S, KH, D], written in place (a private buffer)
    v_buf: torch.Tensor,
    ks_buf: Optional[torch.Tensor],  # [B, S, KH] f32 scales of an int8 cache, else None
    vs_buf: Optional[torch.Tensor],
    past_len: torch.Tensor,  # [B] int32 on x's device
    live: int,  # a host bound on the keys the block sees: max(past_len) + T
    q_valid: torch.Tensor,  # [B]
    cos: torch.Tensor,  # [B, T, D]
    sin: torch.Tensor,
    attn_impl: str = "auto",
    tp=None,
) -> torch.Tensor:
    """One decoder layer over a new token block; writes the block's K/V into
    k_buf/v_buf at [past_len, past_len + T) (an int8 cache: codes, and
    scales into ks_buf/vs_buf) and returns the new x. The block's start is
    clamped into the buffer, as JAX's dynamic_update_slice clamps it.

    tp (`parallel.mesh.InferenceTP`): Megatron over this rank's heads and
    FFN columns, the o and down products' partial sums all-reduced."""
    b, t, d = x.shape
    h = cfg.num_attention_heads
    kh = cfg.num_key_value_heads
    hd = cfg.head_dim
    widths, leave = None, (lambda z: z)
    if tp is not None:
        h, kh, widths, leave = tp.heads, tp.kv_heads, tp.widths, tp.leave
    # o and down give fp32 partial sums, their w8a8 rows the whole row's scale
    rowpar = tp if tp is not None and tp.n > 1 else None
    mot = cfg.layer_module == "mot"

    attn_u = lp["attn"]
    attn_g = lp["attn_gen"] if mot else lp["attn"]
    ln_u = lp["input_ln"]
    ln_g = lp["input_ln_gen"] if mot else lp["input_ln"]

    res = x
    hqkv = add_rms_norm_plain(Split.block(x, und_len), (ln_u, ln_g), cfg.rms_norm_eps)[1].whole()
    if und_len >= t:
        q, k, v = _proj_qkv(hqkv, attn_u, h, kh, hd, widths)
    elif und_len <= 0:
        q, k, v = _proj_qkv(hqkv, attn_g, h, kh, hd, widths)
    else:
        qu, ku, vu = _proj_qkv(hqkv[:, :und_len], attn_u, h, kh, hd, widths)
        qg, kg, vg = _proj_qkv(hqkv[:, und_len:], attn_g, h, kh, hd, widths)
        q = torch.cat([qu, qg], dim=1)
        k = torch.cat([ku, kg], dim=1)
        v = torch.cat([vu, vg], dim=1)

    q = _rope_into_cache(cfg, und_len, q, k, v, attn_u, attn_g, cos, sin, k_buf, v_buf,
                         ks_buf, vs_buf, past_len)
    kernel = attn_impl == "flash" or (attn_impl == "auto" and q.is_cuda)
    att = _attend(q, k_buf, v_buf, ks_buf, vs_buf, past_len, live, q_valid, causal, kernel)
    att = att.reshape(b, t, h * hd)

    o = leave(_split_apply(
        att.to(x.dtype), und_len,
        lambda z: _linear(z, attn_u["o"], tp=rowpar),
        lambda z: _linear(z, attn_g["o"], tp=rowpar),
    ))
    if att.dtype != x.dtype:
        # an int8 cache's bf16 attention beside f32 weights: JAX's product
        # promotes it and rounds its result to the attention's dtype
        o = o.to(att.dtype)
    mlp_u = lp["mlp"]
    mlp_g = lp.get("mlp_gen", lp["mlp"])
    pln_u = lp["post_ln"]
    pln_g = lp["post_ln_gen"] if mot else lp["post_ln"]
    x, hn = add_rms_norm_plain(Split.block(o.to(res.dtype), und_len), (pln_u, pln_g),
                               cfg.rms_norm_eps, res=res)

    def ffn(mlp):
        return lambda z: _linear(_ffn_mix(z, mlp, widths), mlp["down"], tp=rowpar)

    m = leave(hn.map(ffn(mlp_u), ffn(mlp_g)).whole())
    return x + m.to(x.dtype)


def _fused(attn_impl: str, x: torch.Tensor) -> bool:
    """Whether a block's layers take the fused elementwise kernels
    (`_layer_extend_fused`): where its attention takes the kernels (B1:
    attn_impl "flash", or "auto" on a CUDA tensor) and the activations are
    bf16. On CPU tensors the kernels' plain versions run."""
    kernel = attn_impl == "flash" or (attn_impl == "auto" and x.is_cuda)
    return kernel and x.dtype == torch.bfloat16


def _per_expert(z: Split, fn_und, fn_gen) -> tuple:
    """fn_und / fn_gen, each giving a tuple of tensors, on each expert's part
    of z: a Split of each of the tuple's tensors."""
    out = [None, None]
    for e, part in z.parts():
        out[e] = (fn_und, fn_gen)[e](part)
    n = len(out[0] if out[0] is not None else out[1])
    return tuple(Split(*(None if o is None else o[i] for o in out), z.und_len, z.t)
                 for i in range(n))


def _experts_over(x: torch.Tensor, und_len: int, fn_und, fn_gen) -> Split:
    """fn_und and fn_gen over each expert's rows of a whole block x [B, T,
    ...] (B1's output): the expert with more rows over the whole block in
    place (the other's few rows computed with it and never read), the other
    over its own rows (a copy where B > 1)."""
    s = Split.block(x, und_len)
    u, t = s.und_len, s.t
    if s.und is None or s.gen is None:
        return s.map(fn_und, fn_gen)
    if t - u >= u:
        return Split(fn_und(x[:, :u]), fn_gen(x), u, t)
    return Split(fn_und(x), fn_gen(x[:, u:]), u, t)


def _layer_extend_fused(
    cfg: Qwen2Config, und_len: int, causal: bool, x: torch.Tensor, carry: Optional[Split],
    lp: dict, k_buf, v_buf, ks_buf, vs_buf, past_len, live: int, q_valid, cos, sin, tp=None,
) -> Tuple[torch.Tensor, Split]:
    """`_layer_extend` through the fused kernels of `ops.layer_elementwise`,
    at the same rounding points: the MoT split read by row (no cat, no copy
    of a strided slice), each residual add inside the next norm. x [B, T, d]
    is the residual stream before the previous layer's FFN output `carry`
    (None at the first layer) is added: that add is this layer's first
    norm's. Returns (x, the FFN output) for the next layer or the final norm.

    A bf16 cache takes `qk_norm_rope`; an int8 cache keeps
    `_rope_into_cache`, whose codes are quantized from the f32 k. Under tp
    the o and down products are merged into one block, all-reduced and
    rounded once, as in `_layer_extend`."""
    b, t, _ = x.shape
    h, kh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    widths = None
    if tp is not None:
        h, kh, widths = tp.heads, tp.kv_heads, tp.widths
    rowpar = tp if tp is not None and tp.n > 1 else None
    mot = cfg.layer_module == "mot"
    attn_u = lp["attn"]
    attn_g = lp["attn_gen"] if mot else lp["attn"]
    mlp_u = lp["mlp"]
    mlp_g = lp.get("mlp_gen", lp["mlp"])
    ln = (lp["input_ln"], lp["input_ln_gen"] if mot else lp["input_ln"])
    pln = (lp["post_ln"], lp["post_ln_gen"] if mot else lp["post_ln"])

    def leave(z: Split) -> Split:
        if tp is None:
            return z
        return Split.block(tp.leave(z.merged()).to(x.dtype), und_len)

    if carry is None:
        _, hn = add_rms_norm(Split.block(x, und_len), ln, eps)
    else:
        x, hn = add_rms_norm(carry, ln, eps, res=x)
    q, k, v = _per_expert(hn, lambda z: _proj_qkv(z, attn_u, h, kh, hd, widths),
                          lambda z: _proj_qkv(z, attn_g, h, kh, hd, widths))
    if k_buf.dtype == torch.bfloat16:
        qk = [(attn_u[n], attn_g[n]) if cfg.qk_norm else None for n in ("q_norm", "k_norm")]
        q = qk_norm_rope(q, k, v, *qk, cos, sin, k_buf, v_buf, past_len, eps)
    else:
        q = _rope_into_cache(cfg, und_len, q.whole(), k.whole(), v.whole(), attn_u, attn_g,
                             cos, sin, k_buf, v_buf, ks_buf, vs_buf, past_len)
    att = _attend(q, k_buf, v_buf, ks_buf, vs_buf, past_len, live, q_valid, causal, True)
    o = _experts_over(att.reshape(b, t, h * hd), und_len,
                      lambda z: _linear(z, attn_u["o"], tp=rowpar),
                      lambda z: _linear(z, attn_g["o"], tp=rowpar))
    x, hn = add_rms_norm(leave(o), pln, eps, res=x)
    gate, up = _per_expert(hn, lambda z: _gate_up(z, mlp_u, widths),
                           lambda z: _gate_up(z, mlp_g, widths))
    m = silu_mul(gate, up).map(lambda z: _linear(z, mlp_u["down"], tp=rowpar),
                               lambda z: _linear(z, mlp_g["down"], tp=rowpar))
    return x, leave(m)


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
    in_place: bool = False,
    kv_bound: Optional[int] = None,
    keep: Optional[torch.Tensor] = None,
    layout=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Run the decoder stack over one new block of tokens.

    Returns final hidden states [B, T, d] (post final-norm, expert-selected)
    and the updated cache (the input cache itself if update_cache=False).
    The input cache is never modified, unless `in_place=True` with
    update_cache: then the block's K/V are written into the given buffers
    themselves, which the caller must own (no other context may share
    them), and the returned cache holds those buffers.

    `kv_bound`: the caller's host bound on the cache lengths (at least
    max(cache.length)); the caller then answers for the capacity, and the
    call reads nothing back from the device (the decode program's steps).
    Without it the lengths are read to the host and a block that would
    overflow the buffer raises. `keep` ([B] bool, with update_cache): rows
    where it is False end with the cache as they found it (a decode step
    after the loop's exit): the entries the block overwrites are read once
    before the layers and put back after them, one gather and one write a
    buffer for the whole stack.

    `layout` (`parallel.mesh.InferenceLayout`): `params` and the cache
    hold this process's shards (module docstring); a layer's leaves are
    gathered at its start, only the und expert's for an und-only block.
    """
    t = embeds.shape[1]
    if kv_bound is None:
        past_host = cache.length.tolist()
        for off in past_host:
            if off + t > cache.max_len:
                raise ValueError(
                    f"KV buffer too small: length {off} + block {t} > {cache.max_len}"
                )
        kv_bound = max(past_host)
    q_valid = q_valid.to(torch.int32)
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)

    if update_cache:
        new = cache if in_place else cache.clone()
        if keep is not None:
            rows, at = _block_at(cache.length, t, cache.max_len)
            held = [None if buf is None else buf[:, rows, at] for buf in new.buffers()]
    # without update_cache the per-layer scratch buffer holds only the live
    # prefix: no key past it is visible, so the bucket's tail is never copied
    live = min(kv_bound + t, cache.max_len)
    tp = None if layout is None else layout.tp
    fused = _fused(attn_impl, embeds)
    x, carry = embeds, None
    for i in range(cfg.num_hidden_layers):
        lp = _layer_params(params["layers"], i)
        if layout is not None:
            lp = layout.gather_tree(lp, "llm/layers", layer=True,
                                    skip=("attn_gen", "mlp_gen") if und_len >= t else ())
        if update_cache:
            bufs = [None if buf is None else buf[i] for buf in new.buffers()]
        else:
            bufs = [None if buf is None else buf[i, :, :live].clone() for buf in cache.buffers()]
        if fused:
            x, carry = _layer_extend_fused(cfg, und_len, causal, x, carry, lp, *bufs,
                                           cache.length, live, q_valid, cos, sin, tp=tp)
            continue
        x = _layer_extend(
            cfg, und_len, causal, x, lp, *bufs, cache.length, live, q_valid, cos, sin,
            attn_impl=attn_impl, tp=tp,
        )

    fin_u = params["final_norm"]
    fin = (fin_u, params.get("final_norm_gen", fin_u))
    # the fused path's last FFN's residual add inside the final norm
    _, x = (add_rms_norm if fused else add_rms_norm_plain)(
        Split.block(x, und_len) if carry is None else carry, fin, cfg.rms_norm_eps,
        res=None if carry is None else x, final=True)
    if update_cache:
        if keep is not None:
            for buf, old in zip(new.buffers(), held):
                if buf is not None:
                    kept = keep.view((1, -1) + (1,) * (old.ndim - 2))
                    buf[:, rows, at] = torch.where(kept, buf[:, rows, at], old)
        return x, dataclasses.replace(new, length=cache.length + q_valid)
    return x, cache


def embed_tokens(params: dict, ids: torch.Tensor, layout=None) -> torch.Tensor:
    """Embedding rows of ids; under `layout` a vocab-parallel lookup in this
    rank's rows, summed over tp."""
    emb = params["embed"]
    quant = isinstance(emb, dict)  # int8 rows with per-row scales
    hit = None
    if layout is not None:
        ids, hit = layout.vocab_ids(ids, (emb["w_q"] if quant else emb).shape[0])
    if quant:
        rows = emb["w_q"][ids].float()
        rows = (rows * emb["row_scale"][ids][..., None]).to(torch.bfloat16)
    else:
        rows = emb[ids]
    return rows if layout is None else layout.vocab_sum(rows, hit)


def lm_logits(params: dict, hidden: torch.Tensor, layout=None) -> torch.Tensor:
    """Logits in fp32 (`_matmul_f32`: no f32 copy of the 1 GB head on
    CUDA). An int8 head dequantizes to hidden's dtype first, as in JAX. Under
    `layout` this rank's part of the vocabulary, the fp32 rows
    all-gathered over tp."""
    head = params["lm_head"]
    if layout is not None:
        head = layout.gather_tree(head, "llm/lm_head")
        return layout.vocab_gather(lm_logits({"lm_head": head}, hidden))
    if "w_q" in head:
        w = (head["w_q"].float() * head["scale"][None, :]).to(hidden.dtype)
    else:
        w = head["w"]
    return _matmul_f32(hidden, w)


# ---------------------------------------------------------------------------
# Packed training forward
# ---------------------------------------------------------------------------


def _select(gen_mask, gen_val, und_val):
    """gen_val on gen tokens, und_val elsewhere (rows of [S, ...])."""
    mask = gen_mask.reshape(gen_mask.shape + (1,) * (gen_val.ndim - 1))
    return torch.where(mask, gen_val, und_val)


def _by_expert(rows, x, fn_und, fn_gen):
    """fn_und over x's und rows and fn_gen over its gen rows (`rows` = (und,
    gen) index tensors), merged back into [S, ...]. fn_* return a tensor or
    a tuple of tensors."""
    und, gen = rows
    ou, og = fn_und(x.index_select(0, und)), fn_gen(x.index_select(0, gen))
    single = torch.is_tensor(ou)
    if single:
        ou, og = (ou,), (og,)
    merged = tuple(
        u.new_empty((x.shape[0],) + u.shape[1:]).index_copy(0, und, u)
        .index_copy(0, gen, g.to(u.dtype))
        for u, g in zip(ou, og)
    )
    return merged[0] if single else merged


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing: keep the outputs of the 2-D products (the
    projections; JAX's dots_with_no_batch_dims_saveable), recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(body, remat):
    """Per-layer activation checkpointing of `body` (the reference wraps its
    decoder layers in apply_activation_checkpointing NO_REENTRANT,
    pretrain_unified_navit.py:567-573).

    remat: True/"full" saves only the layer's input and recomputes the
    layer in the backward (`torch.utils.checkpoint`, use_reentrant=False);
    "dots" keeps the projection products' outputs and recomputes the rest
    (selective checkpointing); False/None/"none" keeps every activation."""
    if remat in (False, None, "none"):
        return body
    if remat in (True, "full"):
        return lambda *a: checkpoint(body, *a, use_reentrant=False)
    if remat == "dots":
        ctx = partial(create_selective_checkpoint_contexts, _dots_policy)
        return lambda *a: checkpoint(body, *a, use_reentrant=False, context_fn=ctx)
    raise ValueError(f"remat must be full|dots|none, got {remat!r}")


def _train_attend(mask, mask_meta, attn_chunk, sparse_block, context_parallel, device):
    """The attention of the packed forward: q [S, H, D], k, v [S, KH, D] ->
    [S, H, D].

    context_parallel = (mesh, axis): ring attention over the axis's ranks
    (JAX's `shard_map` of `ring_packed_attention`): q, k, v and the ids are
    split over the ring on entry, the output gathered on exit, so only the
    attention is sequence-sharded; `attn_chunk` then chunks the ring
    block's query rows."""
    if context_parallel is not None:
        if mask_meta is None:
            raise ValueError("context_parallel needs mask_meta = (document_id, fan_id, noise_id)")
        cp_mesh, cp_axis = context_parallel
        group = cp_mesh.group(cp_axis)
        n, i = cp_mesh.size(cp_axis), cp_mesh.index(cp_axis)
        ids = tuple(t.chunk(n)[i] for t in mask_meta) if n > 1 else tuple(mask_meta)

        def ring(q, k, v):
            q, k, v = (split_seq(t, 0, group)[None] for t in (q, k, v))
            out = ring_packed_attention(q, k, v, *ids, group, q_chunk=attn_chunk)[0]
            return gather_seq(out, 0, group)
        return ring
    if sparse_block is not None:
        if mask_meta is None:
            raise ValueError("sparse_block needs mask_meta = (document_id, fan_id, noise_id)")
        ids = tuple(t.to(torch.int32).contiguous() for t in mask_meta)
        # the kernel's tables depend on the ids alone: built once for every
        # layer and for the remat recompute
        tables = kernel_tables(*ids) if device.type == "cuda" else None
        return lambda q, k, v: sparse_packed_attention_train(q, k, v, *ids, tables=tables)
    if attn_chunk is not None:
        if mask_meta is None:
            raise ValueError("attn_chunk needs mask_meta = (document_id, fan_id, noise_id)")
        return lambda q, k, v: chunked_packed_attention(q, k, v, *mask_meta, chunk=attn_chunk)
    if mask is None:
        raise ValueError("the dense attention path needs the [S, S] mask")
    return lambda q, k, v: dot_attention(q[None], k[None], v[None], mask=mask[None])[0]


def llm_forward_train(
    params: dict,
    cfg: Qwen2Config,
    packed: torch.Tensor,  # [S, d] assembled embeddings
    position_ids: torch.Tensor,  # [S]
    mask: Optional[torch.Tensor],  # [S, S] bool (train_packed_mask) or None
    gen_mask: torch.Tensor,  # [S] bool, True = gen-expert (VAE) token
    remat="full",
    mask_meta: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    attn_chunk: Optional[int] = None,
    context_parallel=None,
    sparse_block: Optional[int] = None,
    layout=None,
    experts=None,
) -> torch.Tensor:
    """Training forward over one packed multi-sample sequence -> final
    hidden states [S, d] (post final norm, per expert).

    Attention: `mask` (dense [S, S]) for moderate S; for long packed
    sequences mask_meta = (document_id, fan_id, noise_id) with `attn_chunk`
    (chunked, plain PyTorch), `sparse_block` (the block-sparse kernel
    B3 on CUDA, whose tiles are fixed at 128: the value only selects the
    path) or `context_parallel` = (mesh, axis) (ring attention).

    `layout` (`parallel.mesh.Layout`): `params` hold this process's shards;
    each layer gathers its leaves at use (inside the recomputed body), and
    under Megatron tp runs its local heads and FFN columns. `experts`
    (`parallel.expert.ExpertParallel`): the MoT expert pair split over two
    processes (`train_layer_block`)."""
    hd = cfg.head_dim
    gen_mask = gen_mask.bool()
    rows = (torch.nonzero(~gen_mask)[:, 0], torch.nonzero(gen_mask)[:, 0])
    cos, sin = rope_cos_sin(position_ids, hd, cfg.rope_theta)
    attend = _train_attend(mask, mask_meta, attn_chunk, sparse_block, context_parallel,
                           packed.device)
    tp = layout.tensor_parallel() if layout is not None else None

    def freeze_und(z):
        return _select(gen_mask, z, z.detach()) if cfg.freeze_und else z

    x = freeze_und(packed)
    layers = params["layers"]
    per_layer = [{} for _ in range(cfg.num_hidden_layers)]
    _unbind_into(layers, per_layer)  # one autograd node per stacked leaf

    def body(x, lp):
        if layout is not None:
            lp = layout.gather_tree(lp, "llm/layers", layer=True)
        return train_layer_block(cfg, lp, x, attend, rows, cos, sin, tp, experts)

    body = remat_wrap(body, remat)
    for lp in per_layer:
        x = body(x, lp)

    eps = cfg.rms_norm_eps
    if cfg.use_moe:
        return _select(gen_mask, rms_norm(x, params["final_norm_gen"], eps),
                       freeze_und(rms_norm(x, params["final_norm"], eps)))
    return rms_norm(x, params["final_norm"], eps)


def _unbind_into(tree: dict, out: list) -> None:
    """Split every stacked [L, ...] leaf of `tree` into per-layer dicts (an
    empty leaf, another process's expert under expert parallelism, stays
    empty in every layer)."""
    def walk(node, dst_path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, dst_path + (k,))
                continue
            for i, t in enumerate(v.unbind(0) if v.numel() else [v] * len(out)):
                d = out[i]
                for key in dst_path:
                    d = d.setdefault(key, {})
                d[k] = t
    walk(tree, ())


def train_layer_block(cfg: Qwen2Config, lp: dict, x, attend, rows, cos, sin, tp=None,
                      experts=None):
    """One decoder layer of the packed training forward: pre-norm attention
    and FFN, each expert over its own rows (`rows` = (und, gen) indexes).
    With cfg.freeze_und the und rows' contributions are detached at JAX's
    points: v, the normed q and k (qk_norm), the output projection and the
    FFN.

    tp (`parallel.mesh.TensorParallel`): Megatron over the layer's local
    heads and FFN columns: the normed input enters the column-parallel
    projections through f (identity, all-reduced gradient), the o and down
    products' partial sums leave through g (all-reduce).

    experts (`parallel.expert.ExpertParallel`): `experts.by_expert` takes
    `_by_expert`'s place (this process's expert over its rows, the pair
    combined across the processes) and `experts.freeze` the detach of the
    und rows' contributions."""
    s = x.shape[0]
    h, kh, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    enter = leave = (lambda t: t)
    if tp is not None:
        h, kh, enter, leave = h // tp.n, kh // tp.n, tp.enter, tp.leave
    mot = cfg.layer_module == "mot"
    eps = cfg.rms_norm_eps
    by_expert = experts.by_expert if experts is not None else _by_expert
    fz = lambda t: t  # noqa: E731
    if cfg.freeze_und:
        fz = experts.freeze if experts is not None else (lambda t: t.detach())
    attn_u = lp["attn"]
    attn_g = lp["attn_gen"] if mot else lp["attn"]

    def qknorm(z, w):
        return rms_norm(z.float(), w, eps)

    def expert_qkv(ln, attn, freeze):
        def fn(xr):
            q, k, v = _proj_qkv(enter(rms_norm(xr, ln, eps)), attn, h, kh, hd)
            if cfg.qk_norm:
                q, k = freeze(qknorm(q, attn["q_norm"])), freeze(qknorm(k, attn["k_norm"]))
            return q, k, freeze(v)
        return fn

    res = x
    if mot:
        q, k, v = by_expert(rows, x, expert_qkv(lp["input_ln"], attn_u, fz),
                            expert_qkv(lp["input_ln_gen"], attn_g, lambda t: t))
    else:
        q, k, v = _proj_qkv(enter(rms_norm(x, lp["input_ln"], eps)), attn_u, h, kh, hd)
        if cfg.qk_norm:
            q, k = qknorm(q, attn_u["q_norm"]), qknorm(k, attn_u["k_norm"])

    q, k = apply_rope(q, k, cos, sin)
    att = attend(q.to(v.dtype), k.to(v.dtype), v).reshape(s, h * hd)
    if mot:
        o = by_expert(rows, att, lambda a: fz(_linear(a, attn_u["o"])),
                      lambda a: _linear(a, attn_g["o"]))
    else:
        o = _linear(att, attn_u["o"])
    x = res + leave(o).to(res.dtype)

    res = x

    def ffn(mlp, pln, freeze=lambda t: t):
        def fn(xr):
            z = enter(xr if pln is None else rms_norm(xr, pln, eps))
            return freeze(_linear(_ffn_mix(z, mlp), mlp["down"]))
        return fn

    if cfg.use_moe and mot:
        m = by_expert(rows, x, ffn(lp["mlp"], lp["post_ln"], fz),
                      ffn(lp["mlp_gen"], lp["post_ln_gen"]))
    elif cfg.use_moe:  # the shared norm over every row, then each expert's FFN
        m = by_expert(rows, rms_norm(x, lp["post_ln"], eps), ffn(lp["mlp"], None, fz),
                      ffn(lp["mlp_gen"], None))
    else:
        m = ffn(lp["mlp"], lp["post_ln"])(x)
    return res + leave(m).to(res.dtype)


# ---------------------------------------------------------------------------
# Greedy / sampled text decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecodeState:
    """The static tensors of a decode step (JAX's while_loop carry), updated
    in place: the input token and its rope position [B], `done` [B], the
    step counter and the step limit [1] on the device, the chunk's output
    [B, chunk] (column i holds step i of the chunk) and the cache, whose
    `length` [B] is the state's own."""

    cache: KVCache
    tok: torch.Tensor
    pos: torch.Tensor
    done: torch.Tensor
    step: torch.Tensor
    limit: torch.Tensor
    out: torch.Tensor


def decode_step(
    params: dict, cfg: Qwen2Config, st: DecodeState, col: int,
    generator: Optional[torch.Generator], *, eos_id: int, temperature: float,
    do_sample: bool, early_stop: bool, frozen: bool, attn_impl: str, layout=None,
) -> None:
    """One step of JAX's decode loop on `st`, with no read back to the host.

    The loop's condition (step < limit, and with early_stop not every row
    done) is evaluated on the device; a step past it attends with q_valid 0,
    writes nothing into the cache, emits eos into `st.out[:, col]` and
    leaves the rest of the state as it was. `frozen` (an `active` mask was
    given): done rows attend with q_valid 0 too."""
    b = st.tok.shape[0]
    go = st.step < st.limit  # [1]
    if early_stop:
        go = go & ~st.done.all()
    rows = go.expand(b) & ~st.done if frozen else go.expand(b)
    hidden, new = llm_extend(
        params, cfg, embed_tokens(params, st.tok, layout)[:, None, :], st.pos[:, None],
        st.cache, rows.to(torch.int32).contiguous(), und_len=1, causal=True,
        update_cache=True, attn_impl=attn_impl, in_place=True, kv_bound=st.cache.max_len,
        keep=go.expand(b), layout=layout,
    )
    logits = lm_logits(params, hidden[:, 0], layout)
    if do_sample:
        probs = torch.softmax(logits / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        nxt = logits.argmax(dim=-1)
    nxt = torch.where(st.done | ~go, eos_id, nxt)
    st.out[:, col] = nxt
    st.done.copy_(st.done | (go & (nxt == eos_id)))
    st.tok.copy_(torch.where(go, nxt, st.tok))
    st.pos.add_(go.to(st.pos.dtype))
    st.step.add_(go.to(st.step.dtype))
    st.cache.length.copy_(new.length)


def decode_text(
    params: dict,
    cfg: Qwen2Config,
    cache: KVCache,
    start_tokens: torch.Tensor,  # [B]
    position_ids: torch.Tensor,  # [B] rope position of the start token
    *,
    max_steps: int,
    eos_id: int,
    temperature: float = 1.0,
    do_sample: bool = False,
    generator: Optional[torch.Generator] = None,
    early_stop: bool = True,
    active: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    in_place: bool = False,
    stats: Optional[dict] = None,
    program=None,
    graph: bool = True,
    layout=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Autoregressive decode. Returns [B, max_steps] tokens (eos-padded
    after stop) and the final cache.

    Each step feeds the previous token (the start token first) as a causal
    und-expert block of one token, then takes the argmax of its logits, or
    with do_sample a draw from softmax(logits / temperature) by `generator`.
    early_stop=True ends the loop as soon as every row has emitted eos;
    False runs all max_steps steps.

    active: optional [B] bool. Rows with active=False are frozen: they emit
    eos from the first step and their cache length never advances.

    The loop runs as JAX's compiled one does: `decode_step` chunk by chunk
    through `program` (an `inference.decode_program.DecodeProgram`; a new
    one if None), min(program.chunk, max_steps) steps a chunk, each chunk
    one CUDA-graph replay on CUDA tensors, or its steps run eagerly on CPU
    tensors or with graph=False (the eager loop, kept to compare against).
    The host reads once a chunk. A live row that would write past the
    buffer raises after its chunk.

    The given cache is left untouched: the loop decodes in the program's own
    copy of it, which the returned cache holds until the program's next
    decode of that shape. With in_place=True the caller owns the given cache
    (JAX donates it): the tokens are written into its buffers. `stats`, if
    given, gets the decoder forwards the loop ran (chunks x chunk) added to
    its "forwards". `layout`: sharded weights and cache (`llm_extend`); a
    graph then holds the step's collectives, and every process of a tp and
    fsdp group captures and replays the same graphs in lockstep.
    """
    from bagel_tpu_torch.inference.decode_program import (
        DecodeProgram,
        buffers_key,
        weights_key,
    )

    b = start_tokens.shape[0]
    dev = start_tokens.device
    if max_steps <= 0:
        return torch.full((b, 0), eos_id, dtype=start_tokens.dtype, device=dev), cache
    prog = program if program is not None else DecodeProgram()
    with prog.lock:  # the program's static buffers are one caller's at a time
        n = min(prog.chunk, max_steps)
        work = cache if in_place else prog.owned_copy(cache)
        frozen = active is not None
        key = ("decode", b, work.max_len, work.k.dtype, weights_key(params), n, do_sample,
               temperature if do_sample else None, eos_id, early_stop, frozen, attn_impl)

        def make_state():
            def z(*shape, dtype=torch.int64):
                return torch.zeros(shape, dtype=dtype, device=dev)

            return DecodeState(
                cache=dataclasses.replace(work, length=z(b, dtype=torch.int32)), tok=z(b),
                pos=z(b), done=z(b, dtype=torch.bool), step=z(1), limit=z(1), out=z(b, n))

        def make_step(st):
            return lambda i, gen: decode_step(
                params, cfg, st, i, gen, eos_id=eos_id, temperature=temperature,
                do_sample=do_sample, early_stop=early_stop, frozen=frozen, attn_impl=attn_impl,
                layout=layout)

        e = prog.entry(key, buffers_key(work), make_state, make_step,
                       lambda st: st.limit.zero_(), n=n, graph=graph and dev.type == "cuda",
                       sampling=do_sample)
        st = e.state
        st.cache.length.copy_(work.length)
        st.tok.copy_(start_tokens)
        st.pos.copy_(position_ids)
        st.done.copy_(~active if frozen else torch.zeros_like(st.done))
        st.step.zero_()
        st.limit.fill_(max_steps)
        cols = []
        while True:
            prog.run(e, generator=generator, stats=stats)
            # the one host read of the chunk: its tokens, done, lengths, the counter
            rep = torch.cat([st.out, st.done[:, None].long(), st.cache.length[:, None].long(),
                             st.step.expand(b)[:, None]], dim=1).cpu()
            cols.append(rep[:, :n])
            if int(rep[:, n + 1].max()) > work.max_len:
                raise ValueError(f"KV buffer too small: a row's length reached "
                                 f"{int(rep[:, n + 1].max())} > {work.max_len}")
            if int(rep[0, n + 2]) >= max_steps or (early_stop and bool(rep[:, n].all())):
                break
        toks = torch.cat(cols, dim=1)[:, :max_steps]
        if toks.shape[1] < max_steps:  # the loop left early: eos past its exit
            toks = torch.cat([toks, torch.full((b, max_steps - toks.shape[1]), eos_id)], dim=1)
        return (toks.to(device=dev, dtype=start_tokens.dtype),
                dataclasses.replace(work, length=st.cache.length.clone()))
