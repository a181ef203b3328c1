"""GenEval scoring: detection filtering, rule evaluation, task summary.

Reimplements the metric definition of the reference's
eval/gen/geneval/evaluation/evaluate_images.py (rule engine :171-230,
box filtering :233-258) and summary_scores.py (:35-62) as pure functions.

The two heavy externals are injected:
- `detect(image_path) -> {classname: [Detection, ...]}` — the reference uses
  mmdet Mask2Former; any detector emitting scored boxes works.
- `classify_colors(image_path, detections, classname) -> [color, ...]` —
  the reference uses CLIP zero-shot over 10 color prompts.
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

COLORS = (
    "red", "orange", "yellow", "green", "blue",
    "purple", "pink", "brown", "black", "white",
)

# task-tag column order of the reference's one-line table
TASK_TAGS = (
    "single_object", "two_object", "counting",
    "colors", "position", "color_attr",
)


@dataclasses.dataclass
class Detection:
    """One scored box. box = (x0, y0, x1, y1); mask optional [H, W] bool."""

    box: Tuple[float, float, float, float]
    score: float
    mask: Optional[np.ndarray] = None


def _iou(a: Sequence[float], b: Sequence[float]) -> float:
    def area(box):
        return max(box[2] - box[0] + 1, 0) * max(box[3] - box[1] + 1, 0)

    inter = area(
        (max(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), min(a[3], b[3]))
    )
    union = area(a) + area(b) - inter
    return inter / union if union else 0.0


def filter_detections(
    raw: Dict[str, List[Detection]],
    *,
    tag: str,
    threshold: float = 0.3,
    counting_threshold: float = 0.9,
    max_objects: int = 16,
    nms_threshold: float = 1.0,
) -> Dict[str, List[Detection]]:
    """Confidence-threshold + greedy same-class NMS, keeping score order.

    Counting prompts use the stricter threshold; nms_threshold 1.0 disables
    suppression (both reference defaults, evaluate_images.py:296-300)."""
    conf = counting_threshold if tag == "counting" else threshold
    out: Dict[str, List[Detection]] = {}
    for classname, dets in raw.items():
        pool = sorted(
            (d for d in dets if d.score > conf),
            key=lambda d: d.score, reverse=True,
        )[:max_objects]
        kept: List[Detection] = []
        while pool:
            best = pool.pop(0)
            kept.append(best)
            if nms_threshold < 1.0:
                pool = [
                    d for d in pool if _iou(best.box, d.box) < nms_threshold
                ]
        if kept:
            out[classname] = kept
    return out


def relative_position(
    obj_a: Detection, obj_b: Detection, position_threshold: float = 0.1
) -> Set[str]:
    """Spatial relations of A w.r.t. B with a dimension-aware dead zone
    (evaluate_images.py:151-168)."""
    boxes = np.asarray([obj_a.box, obj_b.box], np.float64).reshape(2, 2, 2)
    center_a, center_b = boxes.mean(axis=-2)
    dim_a, dim_b = np.abs(np.diff(boxes, axis=-2))[..., 0, :]
    offset = center_a - center_b
    revised = np.maximum(
        np.abs(offset) - position_threshold * (dim_a + dim_b), 0
    ) * np.sign(offset)
    if np.all(np.abs(revised) < 1e-3):
        return set()
    dx, dy = revised / np.linalg.norm(offset)
    rel = set()
    if dx < -0.5:
        rel.add("left of")
    if dx > 0.5:
        rel.add("right of")
    if dy < -0.5:
        rel.add("above")
    if dy > 0.5:
        rel.add("below")
    return rel


def evaluate_sample(
    detections: Dict[str, List[Detection]],
    metadata: dict,
    *,
    classify_colors: Optional[Callable] = None,
    image=None,
    position_threshold: float = 0.1,
) -> Tuple[bool, str]:
    """Apply the GenEval rule engine to filtered detections.

    metadata: {'tag', 'prompt', 'include': [{'class', 'count'[, 'color']
    [, 'position': (rel, group_idx)]}], 'exclude': [...]}. include clauses
    AND together; exclude clauses OR; color/position only checked on the
    top-count most confident boxes (evaluate_images.py:171-230)."""
    correct = True
    reasons: List[str] = []
    matched_groups: List[Optional[List[Detection]]] = []

    for req in metadata.get("include", []):
        classname = req["class"]
        want = req["count"]
        found = detections.get(classname, [])[:want]
        matched = True
        if len(found) < want:
            correct = matched = False
            reasons.append(f"expected {classname}>={want}, found {len(found)}")
        else:
            if "color" in req:
                assert classify_colors is not None, "color check needs a classifier"
                colors = classify_colors(image, found, classname)
                if colors.count(req["color"]) < want:
                    correct = matched = False
                    reasons.append(
                        f"expected {req['color']} {classname}>={want}, found "
                        f"{colors.count(req['color'])} {req['color']}"
                    )
            if "position" in req and matched:
                expected_rel, target_group = req["position"]
                if matched_groups[target_group] is None:
                    correct = matched = False
                    reasons.append(f"no target for {classname} to be {expected_rel}")
                else:
                    for obj in found:
                        for target in matched_groups[target_group]:
                            rels = relative_position(
                                obj, target, position_threshold
                            )
                            if expected_rel not in rels:
                                correct = matched = False
                                reasons.append(
                                    f"expected {classname} {expected_rel} "
                                    f"target, found {' and '.join(rels)}"
                                )
                                break
                        if not matched:
                            break
        matched_groups.append(found if matched else None)

    for req in metadata.get("exclude", []):
        classname = req["class"]
        if len(detections.get(classname, [])) >= req["count"]:
            correct = False
            reasons.append(
                f"expected {classname}<{req['count']}, "
                f"found {len(detections[classname])}"
            )
    return correct, "\n".join(reasons)


def score_image(
    image_path: str,
    metadata: dict,
    detect: Callable[[str], Dict[str, List[Detection]]],
    *,
    classify_colors: Optional[Callable] = None,
    threshold: float = 0.3,
    counting_threshold: float = 0.9,
    max_objects: int = 16,
    nms_threshold: float = 1.0,
    position_threshold: float = 0.1,
) -> dict:
    """Full per-image record (evaluate_image parity, evaluate_images.py:233)."""
    filtered = filter_detections(
        detect(image_path), tag=metadata["tag"], threshold=threshold,
        counting_threshold=counting_threshold, max_objects=max_objects,
        nms_threshold=nms_threshold,
    )
    correct, reason = evaluate_sample(
        filtered, metadata, classify_colors=classify_colors,
        image=image_path, position_threshold=position_threshold,
    )
    return {
        "filename": image_path,
        "tag": metadata["tag"],
        "prompt": metadata["prompt"],
        "correct": correct,
        "reason": reason,
        "metadata": json.dumps(metadata, sort_keys=True),
    }


def summarize(results: Sequence[dict]) -> dict:
    """Per-tag accuracy table + overall (summary_scores.py:35-62).

    Overall = unweighted mean over tasks; prompt-level = any correct image
    per distinct metadata."""
    by_tag: Dict[str, List[bool]] = defaultdict(list)
    by_prompt: Dict[str, List[bool]] = defaultdict(list)
    # preserve first-seen tag order like groupby(sort=False)
    for r in results:
        by_tag[r["tag"]].append(bool(r["correct"]))
        by_prompt[r["metadata"]].append(bool(r["correct"]))
    task_scores = {tag: float(np.mean(v)) for tag, v in by_tag.items()}
    overall = float(np.mean(list(task_scores.values()))) if task_scores else 0.0
    return {
        "total_images": len(results),
        "total_prompts": len(by_prompt),
        "correct_image_frac": (
            float(np.mean([r["correct"] for r in results])) if results else 0.0
        ),
        "correct_prompt_frac": (
            float(np.mean([any(v) for v in by_prompt.values()]))
            if by_prompt else 0.0
        ),
        "task_scores": task_scores,
        "overall": overall,
    }
