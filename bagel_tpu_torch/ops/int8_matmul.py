"""w8a8 matmul: int8 activations x int8 weights -> int32, then the per-token
and per-column scales (port of bagel_tpu/ops/int8_matmul.py).

  out[m, n] = dtype( ((f32(sum_k xq[m,k] wq[k,n]) * xs[m]) * ws[n]) + b[n] )

each float32 step rounded on its own, one rounding to the output dtype at
the end: the order of `qwen2._linear`'s w8a8 branch (without a bias it is
`int8_matmul`'s epilogue). The int32 sums are exact, so the kernel and its
plain version agree bit for bit.

On a CUDA tensor `int8_matmul` launches the hand-written Hopper kernel
`csrc/int8_matmul.cu` (wgmma + TMA; bf16 out, or with out_dtype=float32
the epilogue's value before its rounding, counted also in
`int8_matmul_f32.launches`) or raises; it takes the plain version
`int8_matmul_plain` only for CPU tensors. The kernel reads the
weight K-major: on CUDA `wq` [K, N] must be a transposed view of a
contiguous [N, K] tensor, made once at load by `utils.quant.to_kmajor` /
`w8a8_kmajor` (the wrapper raises on a row-major weight; it never
transposes per call). The plain version takes either layout. The JAX
kernel's tiles (bm, bn, bk) are TPU tiling and are not ported.

`quantize_rows` (the per-token activation quantization feeding it) is a
kernel wrapper too: one pass of `csrc/int8_matmul.cu` on a CUDA tensor,
`quantize_rows_plain` on a CPU tensor. Where a row is split over tensor
parallelism its two halves run apart, as JAX's max over the sharded axis
does: `row_absmax` (each row's absmax of this rank's slice), an all-reduce
with MAX, `row_scale`, then `quantize_rows(x, scale)` (the codes with the
scales given, counted in `quantize_rows_given.launches`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from bagel_tpu_torch.ops import _build

KERNEL = "int8_matmul"


def row_absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Each row's max |x| of x [..., K], f32 [..., 1]."""
    return x.float().abs().amax(dim=-1, keepdim=True)


def row_scale(amax: torch.Tensor) -> torch.Tensor:
    """The w8a8 activation scale of a row absmax: max(amax, 1e-12) / 127."""
    amax = torch.clamp(amax, min=1e-12)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # product with its reciprocal, which is not the IEEE quotient
    return amax / torch.full_like(amax, 127.0)


def quantize_rows_plain(x: torch.Tensor, scale: Optional[torch.Tensor] = None):
    """Dynamic per-token (per-row) symmetric int8 of activations [..., K]:
    (codes int8, scales f32 [..., 1]), as the JAX package's w8a8 `_linear`
    makes them (XLA's work there): scale max(absmax, 1e-12) / 127, codes
    round-half-even(x / scale) clamped to +-127, in f32. `scale` [..., 1]
    f32, if given, is taken in place of the row's own (a tp rank's slice of
    a row quantized with the whole row's scale) and returned as it is."""
    xf = x.float()
    xs = row_scale(row_absmax_plain(xf)) if scale is None else scale
    return torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8), xs


def _check_rows(x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA quantization pass reads bf16 rows, not {x.dtype}")
    if x.ndim != 2 or x.shape[1] % 8:
        raise ValueError(f"x must be [M, K] with K a multiple of 8 (16-byte loads), "
                         f"got {tuple(x.shape)}")
    if x.stride(1) != 1 or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError(f"x: the kernel loads 16-byte row pieces; needs a unit last stride, "
                         f"a row stride that is a multiple of 8 and a 16-byte aligned base "
                         f"(strides {x.stride()})")


def _quant_launch(fn, name: str, x: torch.Tensor, *ptrs) -> None:
    """Launch the quantization pass `name` over the rows of x on its stream."""
    m, k = x.shape
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, name)(x.data_ptr(), x.stride(0), *ptrs, m, k, stream)
    if err:
        msg = lib.int8_matmul_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__} launch failed: {msg} ({err})")
    _build.count_launch(fn)


def quantize_rows(x: torch.Tensor, scale: Optional[torch.Tensor] = None):
    """`quantize_rows_plain`'s (codes [M, K] int8, scales [M, 1] f32) of x
    [M, K]: on a CUDA tensor one launch of the quantization kernel (bf16
    rows; bit-identical to the plain version), on a CPU tensor the plain
    version. With `scale` [M, 1] f32 given, the codes with that scale (the
    given-scale kernel).

    `quantize_rows.launches` counts the launches of the whole pass,
    `quantize_rows_given.launches` those with a given scale."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_rows(x)
    m, k = x.shape
    if scale is not None:
        if scale.device != x.device or scale.dtype != torch.float32 or scale.shape != (m, 1):
            raise ValueError(f"scale must be [{m}, 1] f32 on {x.device}, got "
                             f"{tuple(scale.shape)} {scale.dtype} on {scale.device}")
        scale = scale.contiguous()
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m, 1), dtype=torch.float32, device=x.device) if scale is None else scale
    if m == 0 or k == 0:
        return xq, xs
    if scale is None:
        _quant_launch(quantize_rows, "quantize_rows_bf16", x, xq.data_ptr(), xs.data_ptr())
    else:
        _quant_launch(quantize_rows_given, "quantize_rows_given_bf16", x, xs.data_ptr(),
                      xq.data_ptr())
    return xq, xs


quantize_rows.launches = 0


def quantize_rows_given(x: torch.Tensor, scale: torch.Tensor):
    """`quantize_rows(x, scale)`: the given-scale kernel's launches are
    counted on this function."""
    return quantize_rows(x, scale)


quantize_rows_given.launches = 0


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """`row_absmax_plain` of x [M, K] ([M, 1] f32): on a CUDA tensor one
    launch of the reduce-only kernel (bf16 rows; bit-identical), on a CPU
    tensor the plain version.

    `row_absmax.launches` counts kernel launches."""
    if x.device.type == "cpu":
        return row_absmax_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_rows(x)
    amax = torch.empty((x.shape[0], 1), dtype=torch.float32, device=x.device)
    if x.numel():
        _quant_launch(row_absmax, "row_absmax_bf16", x, amax.data_ptr())
    return amax


row_absmax.launches = 0


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
        lib.int8_matmul_f32.argtypes = fn.argtypes
        lib.int8_matmul_f32.restype = ctypes.c_int
        for name, n_ptrs in (("quantize_rows_bf16", 2), ("quantize_rows_given_bf16", 2),
                             ("row_absmax_bf16", 1)):
            getattr(lib, name).argtypes = [p, ctypes.c_int64] + [p] * n_ptrs + [i, i, p]
            getattr(lib, name).restype = ctypes.c_int
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
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA kernel writes bf16 or f32, not {out_dtype}")
    if not wq.t().is_contiguous():
        raise ValueError(
            f"the CUDA kernel reads the weight k-major: wq [K, N] must be a transposed view "
            f"of a contiguous [N, K] tensor (strides (1, K)), got strides {wq.stride()}; "
            "make it once at load with bagel_tpu_torch.utils.quant.w8a8_kmajor (a tree) "
            "or to_kmajor (a tensor)")


def int8_matmul(
    xq: torch.Tensor,  # [M, K] int8
    xs: torch.Tensor,  # [M, 1] f32 per-token activation scales
    wq: torch.Tensor,  # [K, N] int8; on CUDA k-major (utils.quant.to_kmajor)
    ws: torch.Tensor,  # [N] f32 per-column weight scales
    bias: Optional[torch.Tensor] = None,  # [N], added in f32
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """[M, N] in out_dtype (see the module docstring). Any M, N and K; on
    CUDA, K and N multiples of 16 (every BAGEL matmul), and out_dtype bf16
    or float32 (the f32 instance: the epilogue's value unrounded).

    `int8_matmul.launches` counts kernel launches, `int8_matmul_f32.launches`
    those of the f32 instance among them."""
    if xq.device.type == "cpu":
        return int8_matmul_plain(xq, xs, wq, ws, bias, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"no kernel for device {xq.device}")
    _check(xq, xs, wq, ws, bias, out_dtype)
    m, n = xq.shape[0], wq.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    if m == 0 or n == 0:
        return out
    xq = xq.contiguous()
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("xq and wq must start on 16-byte boundaries (TMA)")
    xs, ws = xs.float().contiguous(), ws.float().contiguous()
    b = None if bias is None else bias.float().contiguous()
    lib = _library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        launch = lib.int8_matmul_f32 if out_dtype == torch.float32 else lib.int8_matmul_bf16
        err = launch(
            xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(),
            m, n, xq.shape[1], stream,
        )
    if err:
        msg = lib.int8_matmul_error_string(err).decode()
        raise RuntimeError(f"int8_matmul launch failed: {msg} ({err})")
    _build.count_launch(int8_matmul)
    if out_dtype == torch.float32:
        _build.count_launch(int8_matmul_f32)
    return out


int8_matmul.launches = 0


def int8_matmul_f32(xq, xs, wq, ws, bias=None) -> torch.Tensor:
    """`int8_matmul(..., out_dtype=torch.float32)`: the f32 instance's
    launches are counted on this function too."""
    return int8_matmul(xq, xs, wq, ws, bias, out_dtype=torch.float32)


int8_matmul_f32.launches = 0
