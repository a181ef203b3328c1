"""Default GenEval detector + CLIP-free color classifier (one command, no
external env).

The reference scores GenEval with an mmdet Mask2Former (Swin-S, trained on
COCO) plus CLIP zero-shot color classification
(eval/gen/geneval/evaluation/evaluate_images.py:58-139) — a stack that
needs its own conda env with mmdet/mmcv pinned. This module ships working
defaults with no dependency beyond torch(+torchvision where available).
The detector runs on CUDA unless a device is named (the port's rule):

- `detect_default(image_path)`: COCO-pretrained torchvision Mask R-CNN
  with the COCO-91 -> GenEval-80 class-name remap. **Score-shifted vs the
  reference's Mask2Former**: absolute GenEval numbers from this detector
  are NOT comparable to the published table (Mask R-CNN R50-FPN is a
  weaker detector; expect a few points lower overall) — it makes
  `score_geneval.sh <imgdir>` run end-to-end anywhere `torchvision` is
  installed. For the exact published operating point, run the reference
  recipe: conda env with mmdet==3.x, download
  mask2former_swin-s-p4-w7-224_lsj_8x2_50e_coco (the checkpoint named in
  evaluate_images.py), and pass `--detections` (precomputed jsonl) or a
  custom `--detector` to gen_scorer.
- `classify_colors_hsv(image, detections, classname)`: color check
  without CLIP — per-pixel HSV rules over the (cropped) detection box,
  majority vote over GenEval's 10 color names. Deterministic, testable,
  and surprisingly competitive for the saturated single-color objects
  GenEval's color prompts generate.

Detector raw-output schema = gen_scorer's `--detector` contract:
{classname: [[x0, y0, x1, y1, score], ...]}.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Sequence

import numpy as np

# torchvision COCO_V1 meta categories (91 entries incl. "N/A" gaps); the
# non-N/A names are exactly the COCO-80 names the GenEval metadata uses
# ("dining table", "potted plant", ... — mmdet uses the same list).
COCO91_NAMES = [
    "__background__", "person", "bicycle", "car", "motorcycle", "airplane",
    "bus", "train", "truck", "boat", "traffic light", "fire hydrant", "N/A",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "N/A",
    "backpack", "umbrella", "N/A", "N/A", "handbag", "tie", "suitcase",
    "frisbee", "skis", "snowboard", "sports ball", "kite", "baseball bat",
    "baseball glove", "skateboard", "surfboard", "tennis racket", "bottle",
    "N/A", "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana",
    "apple", "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza",
    "donut", "cake", "chair", "couch", "potted plant", "bed", "N/A",
    "dining table", "N/A", "N/A", "toilet", "N/A", "tv", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven", "toaster",
    "sink", "refrigerator", "N/A", "book", "clock", "vase", "scissors",
    "teddy bear", "hair drier", "toothbrush",
]

_model_lock = threading.Lock()
_model = None

_MMDET_RECIPE = (
    "exact reproduction of the published GenEval numbers needs the "
    "reference detector: create its conda env (mmdet 3.x + mmcv), fetch "
    "the mask2former_swin-s COCO checkpoint named in the reference's "
    "evaluate_images.py, dump detections to jsonl, then run "
    "`python -m bagel_tpu_torch.eval.gen_scorer geneval <dir> "
    "--detections dets.jsonl`"
)


def _load_model(weights_path: str = None, device=None):
    """Build torchvision Mask R-CNN once (thread-safe singleton), on CUDA
    unless `device` names another device."""
    global _model
    with _model_lock:
        if _model is not None:
            return _model
        try:
            import torchvision
            from torchvision.models.detection import (
                maskrcnn_resnet50_fpn,
            )
        except ImportError as e:
            raise ImportError(
                "torchvision is not installed — the default GenEval "
                "detector needs it (`pip install torchvision`, CPU wheel "
                "is fine). Alternatively pass --detections/--detector to "
                f"gen_scorer; {_MMDET_RECIPE}"
            ) from e
        import torch

        from bagel_tpu_torch.utils.device import resolve_device

        device = resolve_device(device)
        weights_path = weights_path or os.environ.get(
            "BAGEL_GENEVAL_DETECTOR_WEIGHTS")
        if weights_path:
            model = maskrcnn_resnet50_fpn(weights=None, num_classes=91)
            state = torch.load(weights_path, map_location=device,
                               weights_only=True)
            model.load_state_dict(state)
        else:
            # resolves from the TORCH_HOME cache, downloading when the
            # environment has egress
            from torchvision.models.detection import (
                MaskRCNN_ResNet50_FPN_Weights,
            )

            model = maskrcnn_resnet50_fpn(
                weights=MaskRCNN_ResNet50_FPN_Weights.COCO_V1
            )
        model.eval().to(device)
        _model = model
        return _model


def detect_default(image_path: str, device=None) -> Dict[str, List[List[float]]]:
    """gen_scorer `--detector` entry point: torchvision Mask R-CNN boxes
    grouped by COCO class name. Lazily builds the model on first call, on
    CUDA unless `device` names another device."""
    import torch
    from PIL import Image

    model = _load_model(device=device)
    img = Image.open(image_path).convert("RGB")
    x = torch.from_numpy(
        np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
    ).to(next(model.parameters()).device)
    with torch.no_grad():
        (pred,) = model([x])
    out: Dict[str, List[List[float]]] = {}
    for box, label, score in zip(pred["boxes"], pred["labels"],
                                 pred["scores"]):
        name = COCO91_NAMES[int(label)]
        if name in ("__background__", "N/A"):
            continue
        out.setdefault(name, []).append(
            [float(v) for v in box.tolist()] + [float(score)]
        )
    return out


# ---------------------------------------------------------------------------
# CLIP-free color classification (HSV majority vote)
# ---------------------------------------------------------------------------

GENEVAL_COLORS = (
    "red", "orange", "yellow", "green", "blue",
    "purple", "pink", "brown", "black", "white",
)


def _classify_pixels_hsv(h: np.ndarray, s: np.ndarray, v: np.ndarray
                         ) -> np.ndarray:
    """Vectorized per-pixel color id (index into GENEVAL_COLORS).
    h in [0, 360), s/v in [0, 1]."""
    out = np.full(h.shape, -1, np.int32)
    black = v < 0.22
    white = (~black) & (s < 0.18) & (v > 0.72)
    grayish = (~black) & (~white) & (s < 0.14)  # undecided gray: v vote
    out[black] = GENEVAL_COLORS.index("black")
    out[white | (grayish & (v >= 0.5))] = GENEVAL_COLORS.index("white")
    out[grayish & (v < 0.5)] = GENEVAL_COLORS.index("black")

    chroma = out == -1  # saturated pixels: classify by hue
    hue_bins = [
        ("red", 345.0, 360.0), ("red", 0.0, 15.0),
        ("orange", 15.0, 45.0), ("yellow", 45.0, 70.0),
        ("green", 70.0, 165.0), ("blue", 165.0, 255.0),
        ("purple", 255.0, 290.0), ("pink", 290.0, 345.0),
    ]
    for name, lo, hi in hue_bins:
        sel = chroma & (h >= lo) & (h < hi)
        out[sel] = GENEVAL_COLORS.index(name)
    # brown = dark/desaturated red-orange; pink = light, softly saturated
    # red (the two colors HSV hue alone cannot separate)
    warm = chroma & (((h >= 345.0) | (h < 45.0)))
    out[warm & (v < 0.65) & (s > 0.25)] = GENEVAL_COLORS.index("brown")
    reddish = chroma & ((h >= 330.0) | (h < 15.0))
    out[reddish & (v > 0.75) & (s < 0.55)] = GENEVAL_COLORS.index("pink")
    return out


def classify_colors_hsv(image, detections: Sequence, classname: str = ""
                        ) -> List[str]:
    """geneval.evaluate_sample `classify_colors` contract: one GenEval
    color name per detection, from an HSV-rule majority vote over the
    detection's pixels (mask when present, else the center 60% of the
    box — border pixels are mostly background)."""
    from PIL import Image

    img = image if hasattr(image, "convert") else Image.open(image)
    rgb = np.asarray(img.convert("RGB"), np.float32) / 255.0
    hsv = np.asarray(img.convert("HSV"), np.float32)
    h = hsv[..., 0] * (360.0 / 255.0)
    s = hsv[..., 1] / 255.0
    v = hsv[..., 2] / 255.0
    del rgb

    names: List[str] = []
    H, W = h.shape
    for det in detections:
        box = getattr(det, "box", det)
        mask = getattr(det, "mask", None)
        if mask is not None:
            sel = np.asarray(mask, bool)
            hh, ss, vv = h[sel], s[sel], v[sel]
        else:
            x0, y0, x1, y1 = [float(c) for c in box[:4]]
            # central crop: drop 20% margin per side
            mx, my = 0.2 * (x1 - x0), 0.2 * (y1 - y0)
            c0 = max(int(y0 + my), 0)
            c1 = min(max(int(y1 - my), c0 + 1), H)
            d0 = max(int(x0 + mx), 0)
            d1 = min(max(int(x1 - mx), d0 + 1), W)
            hh = h[c0:c1, d0:d1].ravel()
            ss = s[c0:c1, d0:d1].ravel()
            vv = v[c0:c1, d0:d1].ravel()
        if hh.size == 0:
            names.append("black")
            continue
        ids = _classify_pixels_hsv(hh, ss, vv)
        counts = np.bincount(ids[ids >= 0], minlength=len(GENEVAL_COLORS))
        names.append(GENEVAL_COLORS[int(counts.argmax())])
    return names
