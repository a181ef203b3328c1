"""SigLIP NaViT vision tower (port of bagel_tpu/models/siglip.py).

Packed variable-resolution ViT: images are patchified on the host into one
flat token buffer, and full attention is restricted to each image by
segment ids (0 = padding). The patch embed is a Linear over flattened
14x14x3 patches; positions are a 2-D axial RoPE over the patch grid, or a
learned table when `cfg.rope` is False.

Attention: on a CUDA tensor with attn_impl="auto" (or "flash") every layer
runs the hand-written block-sparse kernel (`ops.sparse_flash`, kernel B3)
through `segment_flash_attention`, with a gradient; the O(N^2) segment
mask is never built.
On the CPU, and with attn_impl="dense", it takes `segment_mask` +
`dot_attention`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bagel_tpu_torch.configs import SiglipConfig
from bagel_tpu_torch.ops.attention import dot_attention, segment_mask
from bagel_tpu_torch.ops.norms import layer_norm
from bagel_tpu_torch.ops.rope import apply_rope_2d, rope_2d_tables
from bagel_tpu_torch.ops.sparse_flash import kernel_tables, sparse_packed_attention_train
from bagel_tpu_torch.utils.device import resolve_device


def segment_ids_for_kernel(segment_ids: torch.Tensor):
    """(document_id, fan_id, noise_id) of per-segment full attention:
    document_id = fan_id = segment_ids, noise_id = -1."""
    seg = segment_ids.to(torch.int32).contiguous()
    return seg, seg, torch.full_like(seg, -1)


def segment_flash_attention(
    q: torch.Tensor,  # [N, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # [N] int, 0 = padding
    tables=None,
) -> torch.Tensor:
    """Same-segment full attention through the block-sparse packed kernel.

    Its mask is `same_doc & (causal | same_fan) & remove_noise`; with
    document_id = fan_id = segment_ids and noise_id = -1 it is exactly
    `same_segment & segment != 0`. Padded rows (segment 0) give 0. The
    kernel takes any N, so nothing is padded around the call. `tables`: the
    kernel's tables of these ids, shared by the tower's layers.
    Differentiable (`sparse_packed_attention_train`: on CUDA its backward is
    the backward kernels of `csrc/sparse_packed_attention_bwd.cu`, on the
    CPU their plain twin), so the packed training forward trains the tower
    through it."""
    return sparse_packed_attention_train(q, k, v, *segment_ids_for_kernel(segment_ids),
                                         tables=tables)


def _dense(generator, d_in, d_out, dtype, device, std=0.02):
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32, device=device)
    return {"w": (w * std).to(dtype), "b": torch.zeros((d_out,), dtype=dtype, device=device)}


def _stacked(generator, L, d_in, d_out, dtype, device, std=0.02):
    w = torch.randn((L, d_in, d_out), generator=generator, dtype=torch.float32, device=device)
    return {"w": (w * std).to(dtype), "b": torch.zeros((L, d_out), dtype=dtype, device=device)}


def _linear(x, p):
    """x @ w + b with the bias added in the matmul's epilogue (torch.addmm),
    in fp32 before the one rounding to x.dtype, as the JAX
    `preferred_element_type=f32` product does."""
    w = p["w"]
    out = torch.addmm(p["b"], x.reshape(-1, x.shape[-1]), w)
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


def init_siglip_params(
    generator: torch.Generator, cfg: SiglipConfig, dtype=torch.bfloat16, device=None,
) -> dict:
    """Random-init tower in the JAX layout: per-layer weights stacked on
    axis 0, `[in, out]` matrices, fp32 LayerNorms at 1 / 0. `generator` must
    live on `device`."""
    device = resolve_device(device)
    L, d, f = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    g, dev = generator, device

    def ln_stack():
        return {"w": torch.ones((L, d), device=dev), "b": torch.zeros((L, d), device=dev)}

    params = {
        "patch_embed": _dense(g, cfg.patch_dim, d, dtype, dev),
        "layers": {
            "ln1": ln_stack(),
            "ln2": ln_stack(),
            "attn": {name: _stacked(g, L, d, d, dtype, dev) for name in ("q", "k", "v", "o")},
            "mlp": {
                "fc1": _stacked(g, L, d, f, dtype, dev),
                "fc2": _stacked(g, L, f, d, dtype, dev),
            },
        },
        "post_ln": {"w": torch.ones((d,), device=dev), "b": torch.zeros((d,), device=dev)},
    }
    if not cfg.rope:
        w = torch.randn((cfg.num_patches_per_side**2, d), generator=g,
                        dtype=torch.float32, device=dev)
        params["pos_embed"] = (w * 0.02).to(dtype)
    return params


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def siglip_encode(
    params: dict,
    cfg: SiglipConfig,
    packed_patches: torch.Tensor,  # [N, patch_dim] flattened pixel patches
    position_ids: torch.Tensor,  # [N] flattened grid position per token
    segment_ids: torch.Tensor,  # [N] image index (1-based), 0 = padding
    attn_impl: str = "auto",
) -> torch.Tensor:
    """Encode a packed batch of variable-resolution images -> [N, hidden].

    attn_impl: "auto" takes the kernel on a CUDA tensor and the dense path
    on the CPU; "flash" always takes `segment_flash_attention`; "dense"
    always takes `segment_mask` + `dot_attention`."""
    n = packed_patches.shape[0]
    h = cfg.num_attention_heads
    hd = cfg.head_dim
    eps = cfg.layer_norm_eps
    position_ids = position_ids.long()

    x = _linear(packed_patches, params["patch_embed"])
    if not cfg.rope:
        x = x + params["pos_embed"][position_ids].to(x.dtype)
        rope_tabs = None
    else:
        side = cfg.num_patches_per_side
        tabs = rope_2d_tables(hd // 2, side, side, device=x.device)
        rope_tabs = tuple(t[position_ids] for t in tabs)

    use_flash = attn_impl == "flash" or (attn_impl == "auto" and x.is_cuda)
    mask = None if use_flash else segment_mask(segment_ids[None])  # [1, N, N]
    tables = (kernel_tables(*segment_ids_for_kernel(segment_ids))
              if use_flash and x.is_cuda else None)

    for i in range(cfg.num_hidden_layers):
        lp = _layer(params["layers"], i)
        res = x
        y = layer_norm(x, lp["ln1"]["w"], lp["ln1"]["b"], eps)
        q = _linear(y, lp["attn"]["q"]).reshape(n, h, hd)
        k = _linear(y, lp["attn"]["k"]).reshape(n, h, hd)
        v = _linear(y, lp["attn"]["v"]).reshape(n, h, hd)
        if rope_tabs is not None:
            q, k = apply_rope_2d(q, k, *rope_tabs)
            q, k = q.to(v.dtype), k.to(v.dtype)
        if use_flash:
            att = segment_flash_attention(q, k, v, segment_ids, tables)
        else:
            att = dot_attention(q[None], k[None], v[None], mask=mask)[0]
        x = res + _linear(att.reshape(n, h * hd), lp["attn"]["o"])

        res = x
        y = layer_norm(x, lp["ln2"]["w"], lp["ln2"]["b"], eps)
        y = F.gelu(_linear(y, lp["mlp"]["fc1"]), approximate="tanh")
        x = res + _linear(y, lp["mlp"]["fc2"])
    return layer_norm(x, params["post_ln"]["w"], params["post_ln"]["b"], eps)
