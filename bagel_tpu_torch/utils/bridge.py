"""The weight bridge: a JAX-layout parameter tree of numpy arrays -> tensors.

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


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None):
    """Dicts and lists are walked; every array leaf becomes a tensor on
    `device`. 4-D leaves, which in this tree are the VAE's conv kernels and
    nothing else (the SigLIP tower's leaves are at most 3-D), are
    transposed HWIO -> OIHW. `dtype`, if given, casts every floating-point
    leaf except the scales of quantized leaves (SCALE_KEYS), which stay
    f32."""
    device = resolve_device(device)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        t = _to_tensor(node)
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        if dtype is not None and t.is_floating_point() and key not in SCALE_KEYS:
            t = t.to(dtype)
        return t.to(device)

    return walk(tree)
