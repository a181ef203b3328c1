"""The decoder layer's elementwise passes between its GEMMs, fused, with the
MoT split by row (no TPU kernel: XLA fuses them in the JAX package).

- `add_rms_norm`: the residual add and the next RMSNorm, `y = res + o`,
  `n = rms_norm(y, w)` with the row's expert's weight.
- `qk_norm_rope`: the fp32 QK-norm of q and k with the row's expert's
  weights, rope (`rope.apply_rope`), one rounding to bf16; q returned, k
  and v written into the cache's slots of the block (`block_slots`).
- `silu_mul`: `F.silu(gate) * up`.

A block of T tokens a batch row is split by row: tokens [0, und_len) take
the und expert, the rest the gen expert. A value of such a block is a
`Split`: each expert's part is its own rows or the whole block, which the
kernels read in place, so the layer needs no `torch.cat` and no copy of a
strided slice.

On a CUDA tensor each function launches its kernel of
`csrc/layer_elementwise.cu` (bf16 activations, head dim 128) or raises;
on a CPU tensor it takes its plain version (`*_plain`): the chain of
PyTorch ops that `models.qwen2`'s plain path runs, with its rounding
points, which the kernels keep. `fn.launches` counts each kernel's
launches (`_build.count_launch`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from bagel_tpu_torch.ops import _build
from bagel_tpu_torch.ops.norms import rms_norm
from bagel_tpu_torch.ops.rope import apply_rope

KERNEL = "layer_elementwise"
HEAD_DIM = 128  # qk_norm_rope's, compiled into the kernel (B1's)

Pair = Tuple[torch.Tensor, torch.Tensor]  # (und expert's, gen expert's) weights


@dataclasses.dataclass(frozen=True)
class Split:
    """A [B, T, ...] value of a token block, split by row between the MoT
    experts: tokens [0, und_len) the und expert's, [und_len, T) the gen
    expert's. `und` and `gen` are [B, n, ...]: the expert's own rows (n =
    und_len, or T - und_len) or the whole block (n = T, of which the
    expert's rows are read); None for an expert with no rows."""

    und: Optional[torch.Tensor]
    gen: Optional[torch.Tensor]
    und_len: int
    t: int

    @staticmethod
    def block(x: torch.Tensor, und_len: int) -> "Split":
        """A whole [B, T, ...] tensor: each expert reads its rows of it."""
        t = x.shape[1]
        u = min(max(und_len, 0), t)
        return Split(x if u > 0 else None, x if u < t else None, u, t)

    def parts(self):
        """((expert 0 or 1, its part), ...) for the experts with rows."""
        return tuple((e, p) for e, p in enumerate((self.und, self.gen)) if p is not None)

    def start(self, e: int) -> int:
        """The token of the part's first row (its t0)."""
        part = (self.und, self.gen)[e]
        return 0 if e == 0 or part.shape[1] == self.t else self.und_len

    def rows(self, e: int) -> torch.Tensor:
        """Expert e's own rows [B, n_e, ...] (a slice of a whole part)."""
        part = (self.und, self.gen)[e]
        if part.shape[1] != self.t:
            return part
        return part[:, :self.und_len] if e == 0 else part[:, self.und_len:]

    def whole(self) -> torch.Tensor:
        """The block [B, T, ...]: the experts' rows concatenated (a block
        that both experts read in place, itself)."""
        if self.und is not None and self.und is self.gen:
            return self.und
        rows = [self.rows(e) for e, _ in self.parts()]
        return rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)

    def merged(self) -> torch.Tensor:
        """The block [B, T, ...] as one tensor: a part that holds the whole
        block, with the other expert's rows written into it, else `whole()`."""
        for e, p in self.parts():
            if p.shape[1] == self.t:
                if len(self.parts()) == 2:
                    u = self.und_len
                    (p[:, u:] if e == 0 else p[:, :u]).copy_(self.rows(1 - e))
                return p
        return self.whole()

    def map(self, fn_und, fn_gen) -> "Split":
        """fn_und on the und part, fn_gen on the gen part (each maps rows to
        rows)."""
        fns = (fn_und, fn_gen)
        out = [None, None]
        for e, p in self.parts():
            out[e] = fns[e](p)
        return Split(out[0], out[1], self.und_len, self.t)


def block_slots(past_len: torch.Tensor, t: int, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (rows [B, 1], slots [B, T]) a T-token block takes in an s-slot
    buffer: [past_len, past_len + T), the start clamped into the buffer as
    JAX's dynamic_update_slice clamps it."""
    rows = torch.arange(past_len.shape[0], device=past_len.device)[:, None]
    start = torch.clamp(past_len.to(torch.int64), max=s - t)
    return rows, start[:, None] + torch.arange(t, device=past_len.device)[None, :]


def split_apply(x, und_len: int, fn_und, fn_gen):
    """fn_und on x[:, :und_len], fn_gen on the rest, concatenated on axis 1;
    a single-expert block runs one function only."""
    t = x.shape[1]
    if und_len >= t:
        return fn_und(x)
    if und_len <= 0:
        return fn_gen(x)
    return torch.cat([fn_und(x[:, :und_len]), fn_gen(x[:, und_len:])], dim=1)


def _own(x: torch.Tensor, und_len: int, fn_und, fn_gen) -> Split:
    """fn_und / fn_gen on the experts' own rows of a whole block x."""
    s = Split.block(x, und_len)
    return s.map(lambda z: fn_und(z[:, :s.und_len]), lambda z: fn_gen(z[:, s.und_len:]))


def _empty(b: int, t: int, width: int, und_len: int, dev) -> Split:
    """Uninitialized bf16 rows [B, n, width], each expert's own."""
    u = min(max(und_len, 0), t)

    def new(n):
        return torch.empty((b, n, width), dtype=torch.bfloat16, device=dev) if n else None

    return Split(new(u), new(t - u), u, t)


# ---------------------------------------------------------------------------
# Plain versions: the chain of PyTorch ops each kernel replaces
# ---------------------------------------------------------------------------


def add_rms_norm_plain(o: Split, w: Pair, eps: float, res: Optional[torch.Tensor] = None,
                       *, final: bool = False):
    """(y, n): y = res + o (None without res), n = `rms_norm` of y's rows
    with their expert's weight, a Split of each expert's own rows. `final`
    (the stack's last norm): n one [B, T, d] tensor, y not kept (None).
    The plain path's norms (`models.qwen2`) are these."""
    y = o.whole() if res is None else res + o.whole()
    n = _own(y, o.und_len, lambda z: rms_norm(z, w[0], eps), lambda z: rms_norm(z, w[1], eps))
    if final:
        return None, n.whole()
    return (None if res is None else y), n


def qk_norm_rope_f32(q: torch.Tensor, k: torch.Tensor, und_len: int, q_norm: Optional[Pair],
                     k_norm: Optional[Pair], cos: torch.Tensor, sin: torch.Tensor,
                     eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k [B, T, heads, D] before their rounding: the fp32 RMSNorm of
    each head with the row's expert's weight (where q_norm / k_norm are
    given; upstream keeps it in fp32 on the gen path), then rope from cos /
    sin [B, T, D] in fp32. An int8 cache quantizes this k."""
    if q_norm is not None:
        def qknorm(z, wts):
            return split_apply(z, und_len, lambda a: rms_norm(a.float(), wts[0], eps),
                               lambda a: rms_norm(a.float(), wts[1], eps))

        q, k = qknorm(q, q_norm), qknorm(k, k_norm)
    return apply_rope(q, k, cos, sin)


def qk_norm_rope_plain(q: Split, k: Split, v: Split, q_norm: Optional[Pair],
                       k_norm: Optional[Pair], cos: torch.Tensor, sin: torch.Tensor,
                       k_buf: torch.Tensor, v_buf: torch.Tensor, past_len: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """`qk_norm_rope_f32`'s q rounded to the cache's dtype; its k and v
    written into k_buf / v_buf [B, S, KH, D] at `block_slots`. The plain
    path's q/k code over a bf16 or f32 cache (`models.qwen2`) is this."""
    q, k = qk_norm_rope_f32(q.whole(), k.whole(), q.und_len, q_norm, k_norm, cos, sin, eps)
    rows, at = block_slots(past_len, q.shape[1], k_buf.shape[1])
    k_buf[rows, at] = k.to(k_buf.dtype)
    v_buf[rows, at] = v.whole().to(v_buf.dtype)
    return q.to(k_buf.dtype)


def silu_mul_plain(gate: Split, up: Split) -> Split:
    """`F.silu(gate) * up` over each expert's own rows."""
    out = [None, None]
    for e, _ in gate.parts():
        out[e] = F.silu(gate.rows(e)) * up.rows(e)
    return Split(out[0], out[1], gate.und_len, gate.t)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.add_rms_norm_bf16.argtypes is None:  # declare the C signatures once
        p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        lib.add_rms_norm_bf16.argtypes = [p, p, p, p, i, p, p, i, i, i, i, f, p]
        lib.qk_norm_rope_bf16.argtypes = ([p] * 7 + [i] + [p] * 4 + [i64, i64, p, i64, i64, p]
                                          + [i] * 6 + [f, p])
        lib.silu_mul_bf16.argtypes = [p, p, p, i, i, i, i, p]
        for fn in (lib.add_rms_norm_bf16, lib.qk_norm_rope_bf16, lib.silu_mul_bf16):
            fn.restype = ctypes.c_int
        lib.layer_elementwise_error_string.argtypes = [i]
        lib.layer_elementwise_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(name: str, t: torch.Tensor, inner: int) -> None:
    """t [B, n, ...]: bf16 on CUDA, its last `inner` axes one contiguous row
    (a unit last stride), 16-byte pieces (row strides multiples of 8)."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"the kernels take bf16 rows; {name} is {t.dtype}")
    size = 1
    for ax in range(t.ndim - 1, t.ndim - 1 - inner, -1):
        if t.stride(ax) != size and t.shape[ax] > 1:
            raise ValueError(f"{name}: each row must be contiguous (shape {tuple(t.shape)}, "
                             f"strides {t.stride()})")
        size *= t.shape[ax]
    # an axis of one row is never stepped along: its stride does not matter
    if any(t.stride(ax) % 8 and t.shape[ax] > 1 for ax in (0, 1)) or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernels load 16-byte pieces; needs batch and row "
                         f"strides that are multiples of 8 and a 16-byte aligned base "
                         f"(strides {t.stride()})")


def _desc(s: Split, name: str, inner: int = 1):
    """The kernel's 8 int64: (pointer, batch stride, row stride, t0) of the
    und part, then the gen part (an expert without rows repeats the other's)."""
    vals = []
    first = s.parts()[0][1]
    for e, p in s.parts():
        own = (s.und_len, s.t - s.und_len)[e]
        if (p.shape[1] not in (own, s.t) or p.shape[0] != first.shape[0]
                or p.shape[2:] != first.shape[2:] or p.device != first.device):
            raise ValueError(f"{name}: parts {[tuple(x.shape) for _, x in s.parts()]} do not "
                             f"split a block of {s.t} tokens at {s.und_len}")
        _aligned(f"{name}[{e}]", p, inner)
        vals.append((p.data_ptr(), p.stride(0), p.stride(1), s.start(e)))
    if len(vals) == 1:
        vals *= 2
    return (ctypes.c_int64 * 8)(*vals[0], *vals[1])


def _weights(pair: Optional[Pair], dev, n: int):
    """(und pointer, gen pointer, bf16 flag) of an expert weight pair [n]."""
    if pair is None:
        return None, None, 0
    dtypes = {w.dtype for w in pair}
    if len(dtypes) != 1 or dtypes - {torch.float32, torch.bfloat16}:
        raise TypeError(f"expert weights must be both f32 or both bf16, got {dtypes}")
    for w in pair:
        if w.device != dev or w.shape != (n,) or not w.is_contiguous() or w.data_ptr() % 16:
            raise ValueError(f"a weight must be a contiguous, 16-byte aligned [{n}] tensor "
                             f"on {dev}, got {tuple(w.shape)} on {w.device}")
    return pair[0].data_ptr(), pair[1].data_ptr(), int(pair[0].dtype == torch.bfloat16)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise(fn, lib, err: int) -> None:
    if err:
        msg = lib.layer_elementwise_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__} launch failed: {msg} ({err})")


def _device(s: Split) -> torch.device:
    dev = s.parts()[0][1].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev


def add_rms_norm(o: Split, w: Pair, eps: float, res: Optional[torch.Tensor] = None,
                 *, final: bool = False):
    """`add_rms_norm_plain`'s (y, n): on a CUDA tensor one launch of the
    kernel (bf16, d a multiple of 8), whose y equals the plain one bit for
    bit and n within one bf16 rounding (the order of the sum of squares)."""
    dev = _device(o)
    if dev.type == "cpu":
        return add_rms_norm_plain(o, w, eps, res, final=final)
    part = o.parts()[0][1]
    b, t, d = part.shape[0], o.t, part.shape[-1]
    if d % 8:
        raise ValueError(f"the kernel loads 16-byte pieces: d ({d}) must be a multiple of 8")
    w_u, w_g, w_bf16 = _weights(w, dev, d)
    y = None
    if res is not None:
        if res.shape != (b, t, d) or res.device != dev:
            raise ValueError(f"res must be [{b}, {t}, {d}] on {dev}, got {tuple(res.shape)}")
        y = None if final else torch.empty((b, t, d), dtype=torch.bfloat16, device=dev)
    if final:
        n = Split.block(torch.empty((b, t, d), dtype=torch.bfloat16, device=dev), o.und_len)
    else:
        n = _empty(b, t, d, o.und_len, dev)
    if b * t:
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.add_rms_norm_bf16(
                None if res is None else _desc(Split.block(res, o.und_len), "res"),
                _desc(o, "o"), w_u, w_g, w_bf16,
                None if y is None else _desc(Split.block(y, o.und_len), "y"),
                _desc(n, "n"), b, t, o.und_len, d, eps, _stream(dev))
        _raise(add_rms_norm, lib, err)
        _build.count_launch(add_rms_norm)
    return y, (n.parts()[0][1] if final else n)


add_rms_norm.launches = 0


def qk_norm_rope(q: Split, k: Split, v: Split, q_norm: Optional[Pair],
                 k_norm: Optional[Pair], cos: torch.Tensor, sin: torch.Tensor,
                 k_buf: torch.Tensor, v_buf: torch.Tensor, past_len: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """`qk_norm_rope_plain`: on a CUDA tensor one launch of the kernel (head
    dim 128; q, k, v bf16 [B, n, heads, 128] parts, a bf16 cache, q out in
    bf16), within
    one bf16 rounding of the plain version (the order of each head's sum of
    squares); the v it writes equals the plain one bit for bit."""
    dev = _device(q)
    if dev.type == "cpu":
        return qk_norm_rope_plain(q, k, v, q_norm, k_norm, cos, sin, k_buf, v_buf, past_len,
                                  eps)
    part = q.parts()[0][1]
    b, t, h, d = part.shape[0], q.t, part.shape[2], part.shape[3]
    bs, s, kh = k_buf.shape[0], k_buf.shape[1], k_buf.shape[2]
    if d != HEAD_DIM or k_buf.shape[3] != HEAD_DIM or bs != b:
        raise ValueError(f"q parts {tuple(part.shape)} and k_buf {tuple(k_buf.shape)}: the kernel "
                         f"takes head dim {HEAD_DIM} and one cache row a batch row")
    for name, buf in (("k_buf", k_buf), ("v_buf", v_buf)):
        if (buf.dtype != torch.bfloat16 or buf.shape != k_buf.shape or buf.device != dev
                or buf.stride(3) != 1 or buf.stride(2) != HEAD_DIM
                or buf.stride(0) % 8 or buf.stride(1) % 8 or buf.data_ptr() % 16):
            raise ValueError(f"{name} must be a bf16 [B, S, KH, {HEAD_DIM}] buffer with "
                             f"contiguous slots on {dev} (got {buf.dtype} "
                             f"{tuple(buf.shape)}, strides {buf.stride()})")
    if t > s:
        raise ValueError(f"a block of {t} tokens does not fit {s} slots")
    for name, tab in (("cos", cos), ("sin", sin)):
        if tab.dtype != torch.float32 or tab.shape != (b, t, d) or not tab.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 [{b}, {t}, {d}] tensor")
    if past_len.dtype != torch.int32 or past_len.shape != (b,) or not past_len.is_contiguous():
        raise ValueError(f"past_len must be a contiguous int32 [{b}] tensor")
    for name, x, heads in (("k", k, kh), ("v", v, kh)):
        if any(p.shape[2:] != (heads, d) for _, p in x.parts()):
            raise ValueError(f"{name}: parts must be [B, n, {heads}, {d}]")
    if (q_norm is None) != (k_norm is None):
        raise ValueError("q_norm and k_norm come together")
    qn = _weights(q_norm, dev, d)
    kn = _weights(k_norm, dev, d)
    if qn[2] != kn[2]:
        raise TypeError("q_norm and k_norm must have one dtype")
    q_out = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=dev)
    if b * t:
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.qk_norm_rope_bf16(
                _desc(q, "q", 2), _desc(k, "k", 2), _desc(v, "v", 2), qn[0], qn[1], kn[0], kn[1],
                qn[2], cos.data_ptr(), sin.data_ptr(), q_out.data_ptr(),
                k_buf.data_ptr(), k_buf.stride(0), k_buf.stride(1),
                v_buf.data_ptr(), v_buf.stride(0), v_buf.stride(1),
                past_len.data_ptr(), b, s, t, q.und_len, h, kh, eps, _stream(dev))
        _raise(qk_norm_rope, lib, err)
        _build.count_launch(qk_norm_rope)
    return q_out


qk_norm_rope.launches = 0


def silu_mul(gate: Split, up: Split) -> Split:
    """`silu_mul_plain`: on a CUDA tensor one launch of the kernel (bf16, f a
    multiple of 8) over both experts' rows, bit for bit the plain version."""
    dev = _device(gate)
    if dev.type == "cpu":
        return silu_mul_plain(gate, up)
    part = gate.parts()[0][1]
    b, t, f = part.shape[0], gate.t, part.shape[-1]
    if f % 8:
        raise ValueError(f"the kernel loads 16-byte pieces: f ({f}) must be a multiple of 8")
    out = _empty(b, t, f, gate.und_len, dev)
    if b * t:
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.silu_mul_bf16(_desc(gate, "gate"), _desc(up, "up"), _desc(out, "out"),
                                    b, t, gate.und_len, f, _stream(dev))
        _raise(silu_mul, lib, err)
        _build.count_launch(silu_mul)
    return out


silu_mul.launches = 0
