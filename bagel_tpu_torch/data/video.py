"""Video frame sampling for video SFT / video2video data (port of
bagel_tpu/data/video.py).

Mirrors the reference FrameSampler semantics (data/video_utils.py:23-165):
sample `num_frames` (uniformly within a max-fps cap) from a clip and return
PIL frames plus their frame indexes (used as rope frame_deltas by the
packer's _add_video plan, interleave_t2i_dataset.py:90-131).

Decoding backends: a directory of frame images (always available), or a
video file through decord (the reference's), imported when a file is read;
without decord a file raises RuntimeError. PIL is imported where frames are
read, not with the module.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def sample_frame_indexes(
    total_frames: int, fps: float, num_frames: int, max_fps: float = 2.0
) -> List[int]:
    """Uniform sampling capped at max_fps effective rate."""
    duration = total_frames / max(fps, 1e-6)
    n = min(num_frames, max(1, int(duration * max_fps)), total_frames)
    if n <= 1:
        return [total_frames // 2]
    idx = np.linspace(0, total_frames - 1, n)
    return [int(round(i)) for i in idx]


class FrameSampler:
    def __init__(self, num_frames: int = 8, max_fps: float = 2.0):
        self.num_frames = num_frames
        self.max_fps = max_fps

    def __call__(self, path: str) -> List[Image.Image]:
        frames, _ = self.sample_with_indexes(path)
        return frames

    def sample_with_indexes(
        self, path: str
    ) -> Tuple[List[Image.Image], List[int]]:
        if os.path.isdir(path):
            return self._from_dir(path)
        try:
            return self._from_decord(path)
        except ImportError:
            raise RuntimeError(
                f"no video decoder available for {path}: install decord or "
                "pass a directory of frames"
            )

    def _from_dir(self, path: str):
        from PIL import Image

        files = sorted(
            f for f in os.listdir(path)
            if f.lower().endswith((".jpg", ".jpeg", ".png"))
        )
        idx = sample_frame_indexes(len(files), self.max_fps, self.num_frames,
                                   self.max_fps)
        frames = [
            Image.open(os.path.join(path, files[i])).convert("RGB")
            for i in idx
        ]
        return frames, idx

    def _from_decord(self, path: str):
        import decord  # gated: not in the base image
        from PIL import Image

        vr = decord.VideoReader(path)
        idx = sample_frame_indexes(len(vr), vr.get_avg_fps(),
                                   self.num_frames, self.max_fps)
        arr = vr.get_batch(idx).asnumpy()
        return [Image.fromarray(a) for a in arr], idx
