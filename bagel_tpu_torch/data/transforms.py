"""Image transforms on the host (a copy of MaxLongEdgeMinShortEdgeResize and
ImageTransform from bagel_tpu/data/transforms.py, upstream
data/transforms.py:15-115).

- MaxLongEdgeMinShortEdgeResize: scale so that the long edge is at most
  max_size and the short edge at least min_size, snap both sides to stride
  multiples (rounded, at least one stride), cap the pixel count (shrink and
  snap again), then cap the long edge again.
- ImageTransform: a PIL image is resized, scaled to [0, 1] and normalized
  (mean 0.5, std 0.5) to [-1, 1]; an HWC array is taken as already in
  [-1, 1] and cropped to stride multiples.
- pil_img2rgb: RGB of a PIL image, a transparent one laid on white.
- The training pipeline's helpers (bagel_tpu/data/transforms.py:105-203):
  `patchify_image`, the corruption augmentations for editing-style data
  (decolorization, downscale, gaussian_blur, shuffle_patch,
  inpainting_mask), `split_integer_exp_decay` and `len2weight`.

The output is HWC float32, the engine's image layout. PIL is imported only
where a PIL image is made or changed: the array path needs numpy alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

BICUBIC = 3  # PIL.Image.BICUBIC


class MaxLongEdgeMinShortEdgeResize:
    def __init__(
        self,
        max_size: int,
        min_size: int,
        stride: int,
        max_pixels: int,
        resample: Optional[int] = BICUBIC,
    ):
        self.max_size = max_size
        self.min_size = min_size
        self.stride = stride
        self.max_pixels = max_pixels
        self.resample = resample

    def _make_divisible(self, value: float) -> int:
        return max(self.stride, int(round(value / self.stride) * self.stride))

    def _apply_scale(self, width: int, height: int, scale: float) -> Tuple[int, int]:
        w = self._make_divisible(round(width * scale))
        h = self._make_divisible(round(height * scale))
        return w, h

    def target_size(self, width: int, height: int, img_num: int = 1) -> Tuple[int, int]:
        scale = min(self.max_size / max(width, height), 1.0)
        scale = max(scale, self.min_size / min(width, height))
        new_w, new_h = self._apply_scale(width, height, scale)

        if new_w * new_h > self.max_pixels / img_num:
            scale = self.max_pixels / img_num / (new_w * new_h)
            new_w, new_h = self._apply_scale(new_w, new_h, scale)

        if max(new_w, new_h) > self.max_size:
            scale = self.max_size / max(new_w, new_h)
            new_w, new_h = self._apply_scale(new_w, new_h, scale)
        return new_w, new_h

    def __call__(self, img, img_num: int = 1):
        """img: a PIL image; returns the resized PIL image."""
        new_w, new_h = self.target_size(img.width, img.height, img_num)
        return img.resize((new_w, new_h), self.resample)


class ImageTransform:
    """resize -> HWC float32 in [-1, 1]."""

    def __init__(
        self,
        max_image_size: int,
        min_image_size: int,
        image_stride: int,
        max_pixels: int = 14 * 14 * 9 * 1024,
        image_mean=(0.5, 0.5, 0.5),
        image_std=(0.5, 0.5, 0.5),
    ):
        self.stride = image_stride
        self.resize_transform = MaxLongEdgeMinShortEdgeResize(
            max_size=max_image_size,
            min_size=min_image_size,
            stride=image_stride,
            max_pixels=max_pixels,
        )
        self.mean = np.asarray(image_mean, np.float32)
        self.std = np.asarray(image_std, np.float32)

    def __call__(self, img, img_num: int = 1) -> np.ndarray:
        if isinstance(img, np.ndarray):
            # already an HWC float array: only its sides snap to the stride
            h = img.shape[0] // self.stride * self.stride
            w = img.shape[1] // self.stride * self.stride
            return img[:h, :w].astype(np.float32)
        img = self.resize_transform(img, img_num=img_num)
        arr = np.asarray(img, np.float32) / 255.0
        return (arr - self.mean) / self.std


def pil_img2rgb(image):
    """RGB conversion that lays a transparent image (RGBA, or a palette with
    a transparent colour) on white (upstream data_utils.py:118-127)."""
    from PIL import Image

    if image.mode == "RGBA" or image.info.get("transparency", None) is not None:
        image = image.convert("RGBA")
        white = Image.new(mode="RGB", size=image.size, color=(255, 255, 255))
        white.paste(image, mask=image.split()[3])
        return white
    return image.convert("RGB")


def patchify_image(image: np.ndarray, patch_size: int) -> np.ndarray:
    """HWC image -> [num_patches, p*p*c] rows in (p, q, c) order
    (data_utils.py:43-50 layout parity)."""
    h, w, c = image.shape
    p = patch_size
    assert h % p == 0 and w % p == 0, (h, w, p)
    x = image.reshape(h // p, p, w // p, p, c).transpose(0, 2, 1, 3, 4)
    return x.reshape(-1, p * p * c)


# ---------------------------------------------------------------------------
# Corruption augmentations for editing-style training (reference
# data/transforms.py:118-287 family) — PIL/numpy implementations.
# ---------------------------------------------------------------------------


def decolorization(image):
    from PIL import Image

    gray = image.convert("L")
    if image.mode in ("RGB", "L"):
        return Image.merge(image.mode, [gray] * (3 if image.mode == "RGB" else 1))
    return gray


def downscale(image, factor: float = 4.0):
    """Blur-via-resample corruption (downscale then upscale)."""
    from PIL import Image

    w, h = image.size
    small = image.resize((max(1, int(w / factor)), max(1, int(h / factor))),
                         Image.BILINEAR)
    return small.resize((w, h), Image.BILINEAR)


def gaussian_blur(image, radius: float = 5.0):
    from PIL import ImageFilter

    return image.filter(ImageFilter.GaussianBlur(radius))


def shuffle_patch(image, grid: int = 4, rng: "np.random.Generator" = None):
    """Split into grid x grid patches and permute them."""
    from PIL import Image

    rng = rng or np.random.default_rng(0)
    arr = np.asarray(image)
    h, w = arr.shape[:2]
    ph, pw = h // grid, w // grid
    arr = arr[: ph * grid, : pw * grid]
    tiles = arr.reshape(grid, ph, grid, pw, -1).transpose(0, 2, 1, 3, 4)
    tiles = tiles.reshape(grid * grid, ph, pw, -1)
    tiles = tiles[rng.permutation(grid * grid)]
    out = tiles.reshape(grid, grid, ph, pw, -1).transpose(0, 2, 1, 3, 4)
    out = out.reshape(ph * grid, pw * grid, -1)
    return Image.fromarray(out.squeeze())


def inpainting_mask(image, num_boxes: int = 3, max_frac: float = 0.4,
                    rng: "np.random.Generator" = None):
    """Black out random rectangles (inpainting-source corruption)."""
    from PIL import Image

    rng = rng or np.random.default_rng(0)
    arr = np.asarray(image).copy()
    h, w = arr.shape[:2]
    for _ in range(num_boxes):
        bh = int(rng.integers(h // 8, max(h // 8 + 1, int(h * max_frac))))
        bw = int(rng.integers(w // 8, max(w // 8 + 1, int(w * max_frac))))
        y = int(rng.integers(0, max(1, h - bh)))
        x = int(rng.integers(0, max(1, w - bw)))
        arr[y : y + bh, x : x + bw] = 0
    return Image.fromarray(arr)


def split_integer_exp_decay(total: int, decay: float = 1.0,
                            rng=None) -> Tuple[list, list]:
    """Split `total` into N random parts, N drawn uniformly (decay 1.0) or
    exponentially decayed (data_utils.py:106-115). Returns (parts, cumsum)."""
    import math
    import random as pyrandom

    rng = rng or pyrandom
    if decay == 1.0:
        n = rng.randint(1, total)
    else:
        base = (1 - decay) / (1 - math.pow(decay, total))
        probs = [base * math.pow(decay, i) for i in range(total)]
        n = rng.choices(list(range(1, total + 1)), probs, k=1)[0]
    cuts = [0] + sorted(rng.sample(range(1, total), n - 1)) + [total]
    parts = [cuts[i + 1] - cuts[i] for i in range(len(cuts) - 1)]
    return parts, cuts


def len2weight(x: int, loss_reduction: str = "square") -> float:
    """CE loss reweighting by split length (data_utils.py:168-177)."""
    if x == 0:
        return x
    if loss_reduction == "token":
        return 1.0
    if loss_reduction == "sample":
        return 1.0 / x
    if loss_reduction == "square":
        return 1.0 / (x**0.5)
    raise NotImplementedError(loss_reduction)
