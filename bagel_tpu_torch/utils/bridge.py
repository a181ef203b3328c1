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


def _walk(tree, leaf, key=None):
    if isinstance(tree, dict):
        return {k: _walk(v, leaf, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, leaf) for v in tree)
    return leaf(tree, key)


def _cast(t: torch.Tensor, key, dtype) -> torch.Tensor:
    if dtype is not None and t.is_floating_point() and key not in SCALE_KEYS:
        return t.to(dtype)
    return t


def params_to(tree, device, dtype: Optional[torch.dtype] = None):
    """A tree of tensors (dicts and lists walked) on `device`; `dtype`, if
    given, casts every floating-point leaf but the scales of quantized
    leaves (SCALE_KEYS)."""
    device = resolve_device(device)
    return _walk(tree, lambda t, key: _cast(t, key, dtype).to(device))


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """Dicts and lists are walked; every array leaf becomes a tensor on
    `device`. 4-D leaves, which in this tree are the VAE's conv kernels and
    nothing else (the SigLIP tower's leaves are at most 3-D), are
    transposed HWIO -> OIHW. `dtype`, if given, casts every floating-point
    leaf except the scales of quantized leaves (SCALE_KEYS), which stay
    f32."""
    device = resolve_device(device)

    def leaf(node, key):
        t = _to_tensor(node)
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        return _cast(t, key, dtype).to(device)

    return _walk(tree, leaf)
