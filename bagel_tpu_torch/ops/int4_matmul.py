"""Fused int4 dequant-matmul for few activation rows (decode) (port of
bagel_tpu/ops/int4_matmul.py).

  out[m, n] = bf16( sum_k bf16(x[m,k]) * bf16(f32(nib[k,n] - 8) * scale[k/128, n]) )

with f32 products and sums, where packed row j of `w_p4` holds input rows
2j (low nibble) and 2j+1 (high nibble) (`utils.quant._pack_nibbles`), and
one f32 scale covers 128 input rows of a column. The dequantized weight is
never written to device memory: the kernel reads the packed bytes once.

On a CUDA tensor `int4_matmul` launches the hand-written Hopper kernel
`csrc/int4_matmul.cu` or raises; it takes the plain version
`int4_matmul_plain` only for CPU tensors. The JAX kernel's k-major
relayout, `_KT_MAX` and zero-padded k-groups are TPU tiling and are not
ported.
"""

from __future__ import annotations

import ctypes

import torch

from bagel_tpu_torch.ops import _build
from bagel_tpu_torch.utils.quant import GROUP, dequantize_weight4

KERNEL = "int4_matmul"
MAX_ROWS = 64  # activation rows at most (the bandwidth-bound regime)
_BN = 512  # output columns per block of the kernel (compiled in)
_SM_TARGET = 264  # blocks to aim for: two per SM of an H100


def int4_matmul_plain(x: torch.Tensor, w_p4: torch.Tensor, scale4: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: bf16 x times the weight
    dequantized to bf16, f32 products and sums, a bf16 result."""
    w = dequantize_weight4({"w_p4": w_p4, "scale4": scale4}, torch.bfloat16)
    return (x.to(torch.bfloat16).float() @ w.float()).to(torch.bfloat16)


def split_k(in_: int, out: int) -> tuple:
    """(slices per block, k splits) for the kernel's grid, in slices of 8
    packed rows (one per warp), so that the grid has about _SM_TARGET
    blocks: the k/v projections (512 columns) are a single column tile."""
    n_slices = in_ // 16
    col_tiles = -(-out // _BN)
    want = max(1, min(n_slices, -(-_SM_TARGET // col_tiles)))
    per = -(-n_slices // want)
    return per, -(-n_slices // per)


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.int4_matmul_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.int4_matmul_error_string.argtypes = [i]
        lib.int4_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, w_p4, scale4) -> None:
    m, in_ = x.shape
    kp, out = w_p4.shape
    for name, t in (("w_p4", w_p4), ("scale4", scale4)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if w_p4.dtype != torch.uint8 or scale4.dtype != torch.float32:
        raise TypeError(f"w_p4 must be uint8 and scale4 f32, got {w_p4.dtype}, {scale4.dtype}")
    if kp * 2 != in_ or in_ % GROUP or scale4.shape != (in_ // GROUP, out):
        raise ValueError(f"shapes x {tuple(x.shape)}, w_p4 {tuple(w_p4.shape)}, "
                         f"scale4 {tuple(scale4.shape)}: need in = 2 kp, in % {GROUP} == 0")
    if out % 16 or m > MAX_ROWS:
        raise ValueError(f"the kernel takes out % 16 == 0 and at most {MAX_ROWS} rows, "
                         f"got out={out}, rows={m}")
    if not w_p4.is_contiguous() or w_p4.data_ptr() % 16:
        raise ValueError("w_p4 must be contiguous and 16-byte aligned")


def int4_matmul(x: torch.Tensor, w_p4: torch.Tensor, scale4: torch.Tensor) -> torch.Tensor:
    """x [M, in] @ dequant(w_p4 [in/2, out], scale4 [in/128, out]) -> [M, out]
    bf16 (see the module docstring). M <= 64 on CUDA.

    `int4_matmul.launches` counts calls that launched the kernel (a pass of
    split-k partial sums and the pass that reduces them in a fixed order)."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, w_p4, scale4)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, w_p4, scale4)
    m, in_ = x.shape
    out_n = w_p4.shape[1]
    out = torch.empty((m, out_n), dtype=torch.bfloat16, device=x.device)
    if m == 0:
        return out
    xb = x.to(torch.bfloat16).contiguous()
    scale4 = scale4.contiguous()
    per, splits = split_k(in_, out_n)
    partial = torch.empty((splits, m, out_n), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int4_matmul_bf16(
            xb.data_ptr(), w_p4.data_ptr(), scale4.data_ptr(), partial.data_ptr(),
            out.data_ptr(), m, in_, out_n, per, splits, stream,
        )
    if err:
        msg = lib.int4_matmul_error_string(err).decode()
        raise RuntimeError(f"int4_matmul launch failed: {msg} ({err})")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0


def int4_gemv_eligible(x_rows: int, leaf: dict, device: torch.device) -> bool:
    """The kernel takes a `w_p4` matmul with few activation rows (the
    weight-bandwidth-bound decode regime) on CUDA, at shapes it tiles; the
    JAX package's rule with CUDA in place of the TPU."""
    if "w_p4" not in leaf or device.type != "cuda":
        return False
    kp, out = leaf["w_p4"].shape
    in_ = kp * 2
    return (x_rows <= MAX_ROWS and in_ % GROUP == 0 and out % _BN == 0
            and leaf["scale4"].shape[0] == in_ // GROUP)
