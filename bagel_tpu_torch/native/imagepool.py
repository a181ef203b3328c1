"""ctypes bindings for the native image decode/resize pool (imagepool.cc).

Drop-in accelerator for the host data pipeline: a batch of JPEG byte
buffers is decoded with libjpeg(-turbo) and bicubic-resized + normalized to
[-1, 1] float32 HWC across a C++ thread pool — the GIL is released for the
whole batch, so one Python process saturates every host core (the
reference leans on torch DataLoader worker *processes* for the same job,
pretrain_unified_navit.py:625-650).

Numerical note: the resize is Pillow's convolution resampling (BICUBIC,
support scaling on downscale) including Pillow's uint8 rounding of the
intermediate horizontal pass; coefficients are float32 vs Pillow's 8-bit
fixed point, so per-pixel differences up to ~1.5/255 remain. Falls back to
PIL when the toolchain or libjpeg is missing.
"""

from __future__ import annotations

import ctypes
import io
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "imagepool.cc")

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        from bagel_tpu_torch.native._build import build_library

        lib_path = build_library(_SRC, "bagelimg",
                                 extra_flags=["-ljpeg", "-lpthread"])
        if lib_path is None:
            return None
        lib = ctypes.CDLL(lib_path)
        lib.jpeg_dims.restype = ctypes.c_int
        lib.jpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.decode_resize_batch.restype = ctypes.c_int
        lib.decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.resize_bicubic_norm.restype = None
        lib.resize_bicubic_norm.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def jpeg_dims(data: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) from the JPEG header, or None if not parseable."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.jpeg_dims(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def decode_resize_batch(
    jpegs: Sequence[bytes],
    targets: Sequence[Tuple[int, int]],  # (height, width) per image
    mean: Sequence[float] = (0.5, 0.5, 0.5),
    std: Sequence[float] = (0.5, 0.5, 0.5),
    n_threads: Optional[int] = None,
) -> List[Optional[np.ndarray]]:
    """Decode + resize + normalize a batch of JPEGs in parallel.

    Returns per-image float32 HWC arrays in [-1, 1] (None for images that
    failed to decode natively — caller falls back to PIL for those).
    """
    n = len(jpegs)
    assert len(targets) == n
    lib = _load()
    if lib is None:
        return [_pil_one(b, t, mean, std) for b, t in zip(jpegs, targets)]

    outs = [np.empty((th, tw, 3), np.float32) for th, tw in targets]
    th = np.asarray([t[0] for t in targets], np.int32)
    tw = np.asarray([t[1] for t in targets], np.int32)
    lens = np.asarray([len(b) for b in jpegs], np.int64)
    status = np.zeros(n, np.int32)
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)

    buf_arr = (ctypes.c_char_p * n)(*jpegs)
    out_arr = (ctypes.c_void_p * n)(
        *[o.ctypes.data for o in outs]
    )
    nt = n_threads or min(os.cpu_count() or 1, n)
    lib.decode_resize_batch(
        buf_arr, lens.ctypes.data, th.ctypes.data, tw.ctypes.data, n,
        out_arr, mean_a.ctypes.data, std_a.ctypes.data, nt,
        status.ctypes.data,
    )
    result: List[Optional[np.ndarray]] = []
    for i in range(n):
        if status[i] == 0:
            result.append(outs[i])
        else:  # non-JPEG or corrupt: PIL fallback per image
            result.append(_pil_one(jpegs[i], targets[i], mean, std))
    return result


def _pil_one(data, target, mean, std) -> Optional[np.ndarray]:
    try:
        from PIL import Image

        from bagel_tpu_torch.data.transforms import pil_img2rgb

        img = pil_img2rgb(Image.open(io.BytesIO(data)))
        th, tw = target
        img = img.resize((tw, th), Image.BICUBIC)
        arr = np.asarray(img, np.float32) / 255.0
        return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    except Exception:
        return None


class JpegBatchTransform:
    """Batched native twin of data.transforms.ImageTransform for JPEG bytes:
    header-parse dims -> reference target_size policy -> threaded native
    decode+resize+normalize. One call per packed batch of images."""

    def __init__(self, transform, n_threads: Optional[int] = None):
        # transform: data.transforms.ImageTransform (policy + fallback)
        self.transform = transform
        self.n_threads = n_threads

    def __call__(self, jpegs: Sequence[bytes],
                 img_num: int = 1) -> List[Optional[np.ndarray]]:
        policy = self.transform.resize_transform
        targets = []
        pil_idx = []
        for i, data in enumerate(jpegs):
            dims = jpeg_dims(data)
            if dims is None:  # PNG/WebP or corrupt: resolve dims via PIL
                pil_idx.append(i)
                targets.append((1, 1))
                continue
            w, h = dims
            tw, th = policy.target_size(w, h, img_num=img_num)
            targets.append((th, tw))
        outs = decode_resize_batch(
            jpegs, targets, self.transform.mean, self.transform.std,
            self.n_threads,
        )
        for i in pil_idx:
            outs[i] = self._pil_full(jpegs[i], img_num)
        return outs

    def _pil_full(self, data: bytes, img_num: int) -> Optional[np.ndarray]:
        try:
            from PIL import Image

            from bagel_tpu_torch.data.transforms import pil_img2rgb

            img = pil_img2rgb(Image.open(io.BytesIO(data)))
            return self.transform(img, img_num=img_num)
        except Exception:
            return None
