"""The weight bridge: a JAX-layout parameter tree of numpy arrays -> tensors.

`params_to` moves a tree of tensors to a device (a loaded checkpoint,
`utils.convert.load_checkpoint_dir`), casting its floating-point leaves.

`params_from_numpy` takes the tree `bagel_tpu.models.bagel.init_bagel_params`
builds (as numpy, e.g. `jax.tree.map(np.asarray, params)`) and returns the
port's tree in the same layout: the LLM, the SigLIP tower (`vit`: stacked
`[L, in, out]` weights, `[L, d]` LayerNorms), the connector, the VAE and
the adapters. The one layout change: VAE conv kernels go from HWIO to OIHW.
This module imports no JAX; bf16 leaves arrive as ml_dtypes bfloat16 arrays
and are reinterpreted bit for bit.

Both take `layout=` (`parallel.mesh.InferenceLayout`): each leaf is then
cut to this process's shard before it moves, so the device never holds
more than one whole leaf's shard at a time (a quantized tree arrives
quantized on the whole leaf, and its codes and scales are cut with their
columns).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bagel_tpu_torch.utils.device import resolve_device


def _to_tensor(x) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


# the f32 scales of quantized leaves (utils.quant): never cast
SCALE_KEYS = frozenset({"scale", "scale4", "absmax", "row_scale"})


def _walk(tree, leaf, key=None, path=""):
    if isinstance(tree, dict):
        return {k: _walk(v, leaf, k, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, leaf, None, f"{path}/{i}") for i, v in enumerate(tree))
    return leaf(tree, key, path)


def _cast(t: torch.Tensor, key, dtype) -> torch.Tensor:
    if dtype is not None and t.is_floating_point() and key not in SCALE_KEYS:
        return t.to(dtype)
    return t


def _placed(t: torch.Tensor, path: str, layout) -> torch.Tensor:
    return t if layout is None else layout.place(path, t)


def params_to(tree, device, dtype: Optional[torch.dtype] = None, layout=None):
    """A tree of tensors (dicts and lists walked) on `device`; `dtype`, if
    given, casts every floating-point leaf but the scales of quantized
    leaves (SCALE_KEYS); `layout`: this process's shards (module
    docstring)."""
    device = resolve_device(device)
    return _walk(tree, lambda t, key, path: _placed(_cast(t, key, dtype), path,
                                                    layout).to(device))


def port_layout(t: torch.Tensor, key=None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A JAX-layout leaf tensor in the port's layout: 4-D leaves, which in
    this tree are the VAE's conv kernels and nothing else (the SigLIP
    tower's leaves are at most 3-D), transposed HWIO -> OIHW; `dtype`, if
    given, casts a floating-point leaf unless its `key` is one of the
    quantized leaves' scales (SCALE_KEYS), which stay f32. The parameters'
    tree and every tree of their shape (EMA, Adam's moments) take the same
    map. A meta tensor gives the (dtype, shape) of the result alone."""
    if t.ndim == 4:
        t = t.permute(3, 2, 0, 1).contiguous()
    return _cast(t, key, dtype)


def port_leaf(node, key=None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An array leaf of a JAX-layout tree as the port's CPU tensor
    (`port_layout`)."""
    return port_layout(_to_tensor(node), key, dtype)


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None, layout=None):
    """Dicts and lists are walked; every array leaf becomes a tensor on
    `device` (`port_leaf`: the VAE's conv kernels HWIO -> OIHW; `dtype`, if
    given, casts every floating-point leaf but the quantized leaves'
    scales). `layout`: this process's shards (module docstring)."""
    device = resolve_device(device)
    return _walk(tree, lambda node, key, path: _placed(port_leaf(node, key, dtype), path,
                                                       layout).to(device))
