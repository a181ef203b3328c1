"""ctypes bindings for the native packing helpers (packing.cc, a copy of
bagel_tpu/native/packing.cc).

The library is built at first use with g++ into the checkout's `build/`
(`native._build`); every function takes a pure-Python fallback, with the
same output, when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "packing.cc")

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        from bagel_tpu_torch.native._build import build_library

        lib_path = build_library(_SRC, "bagelpack")
        if lib_path is None:
            return None
        lib = ctypes.CDLL(lib_path)
        lib.pack_spans.restype = ctypes.c_longlong
        lib.pack_spans.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.fill_ranges.restype = ctypes.c_longlong
        lib.fill_ranges.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ]
        lib.build_train_mask.restype = None
        lib.build_train_mask.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def pack_spans(
    spans: np.ndarray, out_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """spans: int64 [n, 7] (doc, fan, noise, n_tokens, rope_mode, rope_start,
    out_offset) -> (doc, fan, noise, pos) int32 arrays of out_len.

    Unwritten slots stay at the padding values (doc 0, fan/noise -1, pos 0).
    """
    spans = np.ascontiguousarray(spans, np.int64)
    doc = np.zeros(out_len, np.int32)
    fan = np.full(out_len, -1, np.int32)
    noi = np.full(out_len, -1, np.int32)
    pos = np.zeros(out_len, np.int32)
    lib = _load()
    if lib is not None:
        lib.pack_spans(
            spans.ctypes.data, len(spans),
            doc.ctypes.data, fan.ctypes.data, noi.ctypes.data, pos.ctypes.data,
        )
        return doc, fan, noi, pos
    # fallback
    for d, f, nz, n, mode, r0, off in spans:
        sl = slice(off, off + n)
        doc[sl] = d
        fan[sl] = f
        noi[sl] = nz
        pos[sl] = np.arange(r0, r0 + n) if mode == 0 else r0
    return doc, fan, noi, pos


def fill_ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    total = int(lens.sum())
    out = np.empty(total, np.int32)
    lib = _load()
    if lib is not None:
        lib.fill_ranges(starts.ctypes.data, lens.ctypes.data, len(starts),
                        out.ctypes.data)
        return out
    k = 0
    for s, n in zip(starts, lens):
        out[k : k + n] = np.arange(s, s + n)
        k += n
    return out


def build_train_mask(doc: np.ndarray, fan: np.ndarray,
                     noi: np.ndarray) -> np.ndarray:
    """Host-side dense mask (debug/validation twin of the device builder)."""
    s = len(doc)
    doc = np.ascontiguousarray(doc, np.int32)
    fan = np.ascontiguousarray(fan, np.int32)
    noi = np.ascontiguousarray(noi, np.int32)
    out = np.zeros((s, s), np.uint8)
    lib = _load()
    if lib is not None:
        lib.build_train_mask(doc.ctypes.data, fan.ctypes.data,
                             noi.ctypes.data, s, out.ctypes.data)
        return out.astype(bool)
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    same_doc = (doc[:, None] == doc[None, :]) & (doc[:, None] != 0)
    same_fan = (fan[:, None] == fan[None, :]) & (fan[:, None] >= 0)
    remove_noise = ~((noi[None, :] >= 0) & (noi[:, None] != noi[None, :]))
    return same_doc & ((i >= j) | same_fan) & remove_noise
