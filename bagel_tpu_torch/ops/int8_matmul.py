"""w8a8 matmul: int8 activations x int8 weights -> int32, then the per-token
and per-column scales (port of bagel_tpu/ops/int8_matmul.py).

  out[m, n] = dtype( ((f32(sum_k xq[m,k] wq[k,n]) * xs[m]) * ws[n]) + b[n] )

each float32 step rounded on its own, one rounding to the output dtype at
the end: the order of `qwen2._linear`'s w8a8 branch (without a bias it is
`int8_matmul`'s epilogue). The int32 sums are exact, so the kernel and its
plain version agree bit for bit.

On a CUDA tensor `int8_matmul` launches the hand-written Hopper kernel
`csrc/int8_matmul.cu` (bf16 out) or raises; it takes the plain version
`int8_matmul_plain` only for CPU tensors. The JAX kernel's tiles (bm, bn,
bk) are TPU tiling and are not ported.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from bagel_tpu_torch.ops import _build

KERNEL = "int8_matmul"


def quantize_rows(x: torch.Tensor):
    """Dynamic per-token (per-row) symmetric int8 of activations [..., K]:
    (codes int8, scales f32 [..., 1]), as the JAX package's w8a8 `_linear`
    makes them (plain PyTorch: XLA's work there)."""
    xf = x.float()
    xs = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-12) / 127.0
    return torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8), xs


def int8_products(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums xq @ wq as float32 (then rounded once, as the
    kernel's int32 -> f32 conversion). On the CPU an int32 matmul; CUDA has
    none, so there the codes multiply in float64, which is exact: every
    |sum| <= 127^2 K < 2^53."""
    if xq.device.type == "cpu":
        acc = xq.to(torch.int32) @ wq.to(torch.int32)
    else:
        acc = xq.double() @ wq.double()
    return acc.float()


def int8_matmul_plain(
    xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
    bias: Optional[torch.Tensor] = None, out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (see the module docstring)."""
    out = int8_products(xq, wq) * xs * ws
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.int8_matmul_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.int8_matmul_error_string.argtypes = [i]
        lib.int8_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _check(xq, xs, wq, ws, bias, out_dtype) -> None:
    m, k = xq.shape
    n = wq.shape[1]
    for name, t in (("xs", xs), ("wq", wq), ("ws", ws), ("bias", bias)):
        if t is not None and t.device != xq.device:
            raise ValueError(f"{name} is on {t.device}, xq on {xq.device}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"xq and wq must be int8, got {xq.dtype} and {wq.dtype}")
    if wq.shape[0] != k or xs.shape != (m, 1) or ws.shape != (n,):
        raise ValueError(f"shapes xq {tuple(xq.shape)}, xs {tuple(xs.shape)}, "
                         f"wq {tuple(wq.shape)}, ws {tuple(ws.shape)}")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias must be [{n}], got {tuple(bias.shape)}")
    if k % 16 or n % 16:
        raise ValueError(f"the kernel loads 16-byte rows: K ({k}) and N ({n}) "
                         "must be multiples of 16")
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel writes bf16, not {out_dtype}")


def int8_matmul(
    xq: torch.Tensor,  # [M, K] int8
    xs: torch.Tensor,  # [M, 1] f32 per-token activation scales
    wq: torch.Tensor,  # [K, N] int8
    ws: torch.Tensor,  # [N] f32 per-column weight scales
    bias: Optional[torch.Tensor] = None,  # [N], added in f32
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """[M, N] in out_dtype (see the module docstring). Any M, N and K; on
    CUDA, K and N multiples of 16 (every BAGEL matmul).

    `int8_matmul.launches` counts kernel launches."""
    if xq.device.type == "cpu":
        return int8_matmul_plain(xq, xs, wq, ws, bias, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"no kernel for device {xq.device}")
    _check(xq, xs, wq, ws, bias, out_dtype)
    m, n = xq.shape[0], wq.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if m == 0 or n == 0:
        return out
    xq, wq = xq.contiguous(), wq.contiguous()
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("xq and wq must start on 16-byte boundaries (16-byte loads)")
    xs, ws = xs.float().contiguous(), ws.float().contiguous()
    b = None if bias is None else bias.float().contiguous()
    lib = _library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = lib.int8_matmul_bf16(
            xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(),
            m, n, xq.shape[1], stream,
        )
    if err:
        msg = lib.int8_matmul_error_string(err).decode()
        raise RuntimeError(f"int8_matmul launch failed: {msg} ({err})")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
