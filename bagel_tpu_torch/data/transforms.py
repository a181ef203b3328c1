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

The output is HWC float32, the engine's image layout. PIL is imported only
where a PIL image is resized: the array path needs numpy alone.
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
