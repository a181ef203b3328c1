"""Fused int4 dequant-matmul for few activation rows (decode) (port of
bagel_tpu/ops/int4_matmul.py).

  out[m, n] = bf16( sum_k bf16(x[m,k]) * bf16(f32(nib[k,n] - 8) * scale[k/128, n]) )

with f32 products and sums, where packed row j of `w_p4` holds input rows
2j (low nibble) and 2j+1 (high nibble) (`utils.quant._pack_nibbles`), and
one f32 scale covers 128 input rows of a column. With a bias the result is
bf16(f32(out) + f32(bias)), the rounding of JAX's `_linear` after its
kernel. The dequantized weight is never written to device memory: the
kernel reads the packed bytes once.

On a CUDA tensor `int4_matmul` launches the hand-written Hopper kernel
`csrc/int4_matmul.cu` (one launch a call, the bias in its epilogue) or
raises; it takes the plain version `int4_matmul_plain` only for CPU
tensors. The JAX kernel's k-major relayout, `_KT_MAX` and zero-padded
k-groups are TPU tiling and are not ported.

Scratch: the partial sums of a split K and the per-tile arrival counters
live in one fixed-size workspace per device, made (zeroed) at the first
call on that device, which must come before any CUDA-graph capture (a
tensor made during capture belongs to the graph, and is not zeroed until
a replay).
Reusing it is safe because the port issues its work on one stream, in
order: a launch starts after the previous one has read its partials and
the last block of each tile has set its counter back to 0. A launch that
faults does not leave counters behind for a later call: the fault is
sticky, and the CUDA context takes no further work.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from bagel_tpu_torch.ops import _build
from bagel_tpu_torch.utils.quant import GROUP, dequantize_weight4

KERNEL = "int4_matmul"
MAX_ROWS = 64  # activation rows at most (the bandwidth-bound regime)
_BN = 256  # output columns per column tile (compiled in)
_ROWS_PER_BLOCK = 4  # activation rows a block takes when M > 1 (compiled in)
_SMS = 132  # SMs of an H100
# packed rows of K a block takes, where that gives one block a SM or more
# and fits the workspace: the fastest split at every decode shape but the
# narrow k/v leaves (chip_smoke.py:int4_split_sweep)
_SPLIT_ROWS = 256
_MIN_BLOCKS = _SMS  # fewer blocks leave SMs idle: split K finer, to 16 rows
_MAX_BLOCKS = 8 * _SMS  # more blocks than this with K split: split coarser
_COUNTERS = 16384  # arrival counters: one per column tile and activation row group
_MAX_OUT = _COUNTERS // -(-MAX_ROWS // _ROWS_PER_BLOCK) * _BN  # the widest output they cover
# the workspace: the counters, then a slot of partial sums for every block
_WORKSPACE = _COUNTERS + _MAX_BLOCKS * _ROWS_PER_BLOCK * _BN
_JAX_OUT_TILE = 512  # the JAX kernel's column tile: its eligibility rule
_BIAS_KIND = {None: 0, torch.bfloat16: 1, torch.float32: 2}


def int4_matmul_plain(x: torch.Tensor, w_p4: torch.Tensor, scale4: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: bf16 x times the weight
    dequantized to bf16, f32 products and sums, a bf16 result; then the
    bias added in f32 and rounded to bf16 again."""
    w = dequantize_weight4({"w_p4": w_p4, "scale4": scale4}, torch.bfloat16)
    out = (x.to(torch.bfloat16).float() @ w.float()).to(torch.bfloat16)
    if bias is not None:
        out = (out.float() + bias.float()).to(torch.bfloat16)
    return out


def blocks(in_: int, out: int, rows: int, rps: int) -> int:
    """The kernel's blocks for x [rows, in_], an [in_ / 2, out] packed
    weight and `rps` packed rows a split: column tiles x activation row
    groups x splits of K."""
    groups = 1 if rows == 1 else -(-rows // _ROWS_PER_BLOCK)
    return -(-out // _BN) * groups * -(-(in_ // 2) // rps)


def grid(in_: int, out: int, rows: int = 1) -> int:
    """The packed rows of K a block takes (its split of K): _SPLIT_ROWS,
    doubled while K is split and the blocks exceed _MAX_BLOCKS (the
    workspace's slots), halved down to 16 while they are fewer than
    _MIN_BLOCKS. Always 16, 32 or a multiple of 64 (a step of 64 rows stays
    in one scale group)."""
    kp = in_ // 2
    rps = _SPLIT_ROWS
    while rps < kp and blocks(in_, out, rows, rps) > _MAX_BLOCKS:
        rps *= 2
    while rps > 16 and blocks(in_, out, rows, rps) < _MIN_BLOCKS:
        rps //= 2
    return rps


_grids: dict = {}  # (in, out, rows) -> grid(in, out, rows)
_fn = None  # the ctypes function, its signature declared once
_workspace: dict = {}  # device index -> f32 [_WORKSPACE]: counters, then partial slots


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load(KERNEL)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int4_matmul_bf16.argtypes = [p, p, p, p, i, p, p, p, i, i, i, i, p]
        lib.int4_matmul_bf16.restype = ctypes.c_int
        lib.int4_matmul_error_string.argtypes = [i]
        lib.int4_matmul_error_string.restype = ctypes.c_char_p
        _fn = lib.int4_matmul_bf16
    return _fn


def _scratch(device: torch.device) -> torch.Tensor:
    """The device's workspace: _COUNTERS counters (uint32, 0 between
    launches), then the partial-sum slots. Made, zeroed, at the device's
    first call, outside CUDA-graph capture."""
    ws = _workspace.get(device.index)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "int4_matmul: the first call on a device makes its workspace, which must "
                "not happen inside CUDA-graph capture; call int4_matmul once on the device "
                "before capturing")
        ws = _workspace[device.index] = torch.zeros(_WORKSPACE, dtype=torch.float32,
                                                    device=device)
    return ws


def _check(x, w_p4, scale4, bias) -> None:
    m, in_ = x.shape
    kp, out = w_p4.shape
    for name, t in (("w_p4", w_p4), ("scale4", scale4), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if w_p4.dtype != torch.uint8 or scale4.dtype != torch.float32:
        raise TypeError(f"w_p4 must be uint8 and scale4 f32, got {w_p4.dtype}, {scale4.dtype}")
    if kp * 2 != in_ or in_ % GROUP or scale4.shape != (in_ // GROUP, out):
        raise ValueError(f"shapes x {tuple(x.shape)}, w_p4 {tuple(w_p4.shape)}, "
                         f"scale4 {tuple(scale4.shape)}: need in = 2 kp, in % {GROUP} == 0")
    if out % 16 or out > _MAX_OUT or m > MAX_ROWS:
        raise ValueError(f"the kernel takes out % 16 == 0, out <= {_MAX_OUT} and at most "
                         f"{MAX_ROWS} rows, got out={out}, rows={m}")
    if (not w_p4.is_contiguous() or w_p4.data_ptr() % 16 or not scale4.is_contiguous()
            or scale4.data_ptr() % 16):
        raise ValueError("w_p4 and scale4 must be contiguous and 16-byte aligned")
    if bias is not None and (bias.dtype not in _BIAS_KIND or bias.shape != (out,)
                             or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous bf16 or f32 [{out}] tensor, got "
                         f"{bias.dtype} {tuple(bias.shape)}")


def _run(x, w_p4, scale4, bias, rps: int) -> torch.Tensor:
    """One launch of the kernel on checked operands, K split every `rps`
    packed rows (16, 32 or a multiple of 64; at most _MAX_BLOCKS blocks
    where K is split)."""
    m, in_ = x.shape
    out_n = w_p4.shape[1]
    dev = x.device
    out = torch.empty((m, out_n), dtype=torch.bfloat16, device=dev)
    if m == 0:
        return out
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
        x = x.to(torch.bfloat16).contiguous().clone()
    ws = _scratch(dev).data_ptr()
    b_ptr, b_kind = (None, 0) if bias is None else (bias.data_ptr(), _BIAS_KIND[bias.dtype])
    args = (x.data_ptr(), w_p4.data_ptr(), scale4.data_ptr(), b_ptr, b_kind,
            ws + 4 * _COUNTERS, ws, out.data_ptr(), m, in_, out_n, rps)
    # the current stream's handle without building a Stream object; the
    # device is entered only when it is not the current one
    if dev.index == torch.cuda.current_device():
        err = _kernel()(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = _kernel()(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        msg = _build.load(KERNEL).int4_matmul_error_string(err).decode()
        raise RuntimeError(f"int4_matmul launch failed: {msg} ({err})")
    _build.count_launch(int4_matmul)
    return out


def int4_matmul(x: torch.Tensor, w_p4: torch.Tensor, scale4: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [M, in] @ dequant(w_p4 [in/2, out], scale4 [in/128, out]) (+ bias
    [out]) -> [M, out] bf16 (see the module docstring). M <= 64 on CUDA.

    `int4_matmul.launches` counts calls that launched the kernel (one
    launch a call)."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, w_p4, scale4, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, w_p4, scale4, bias)
    key = (x.shape[1], w_p4.shape[1], x.shape[0])
    rps = _grids.get(key) or _grids.setdefault(key, grid(*key))
    return _run(x, w_p4, scale4, bias, rps)


int4_matmul.launches = 0


def int4_gemv_eligible(x_rows: int, leaf: dict, device: torch.device,
                       out: Optional[int] = None) -> bool:
    """The kernel takes a `w_p4` matmul with few activation rows (the
    weight-bandwidth-bound decode regime) on CUDA, at shapes it tiles; the
    JAX package's rule with CUDA in place of the TPU. `out`: the whole
    leaf's output width where `leaf` is a tp shard of its columns: JAX's
    rule reads the whole leaf, and the kernel takes the shard (its own
    limit, out % 16, is `_check`'s)."""
    if "w_p4" not in leaf or device.type != "cuda":
        return False
    kp, local_out = leaf["w_p4"].shape
    out = local_out if out is None else out
    in_ = kp * 2
    return (x_rows <= MAX_ROWS and in_ % GROUP == 0 and out % _JAX_OUT_TILE == 0
            and leaf["scale4"].shape[0] == in_ // GROUP)
