"""MME score tables (reference eval/vlm/eval/mme/calculation.py).

Input: per-task lists of (question, gt, prediction) with two questions per
image. Output: the published score = 100*(acc + acc+) per task, summed per
Perception/Cognition group, plus binary precision/recall diagnostics.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

PERCEPTION_TASKS = (
    "existence", "count", "position", "color", "posters", "celebrity",
    "scene", "landmark", "artwork", "OCR",
)
COGNITION_TASKS = (
    "commonsense_reasoning", "numerical_calculation", "text_translation",
    "code_reasoning",
)


def parse_pred_ans(pred: str) -> str:
    """'yes'/'no'/'other' with a 4-char prefix sniff (calculation.py:36-50)."""
    pred = pred.lower()
    if pred in ("yes", "no"):
        return pred
    prefix = pred[:4]
    if "yes" in prefix:
        return "yes"
    if "no" in prefix:
        return "no"
    return "other"


def _binary_metrics(gts: List[str], preds: List[str]) -> Dict[str, float]:
    acc = sum(g == p for g, p in zip(gts, preds)) / max(len(gts), 1)
    tp = sum(1 for g, p in zip(gts, preds) if g == "yes" and p == "yes")
    fn = sum(1 for g, p in zip(gts, preds) if g == "yes" and p != "yes")
    fp = sum(1 for g, p in zip(gts, preds) if g == "no" and p == "yes")
    tn = sum(1 for g, p in zip(gts, preds) if g == "no" and p == "no")
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    other = sum(1 for p in preds if p == "other")
    return {
        "TP": tp, "FN": fn, "TN": tn, "FP": fp,
        "precision": precision, "recall": recall,
        "other_num": other, "acc": acc,
    }


def mme_score(
    task_results: Dict[str, Sequence[Tuple[str, str, str]]],
) -> dict:
    """task_results: {task: [(image_id, gt, raw_pred), ...]} where each image
    contributes exactly two consecutive rows (the MME protocol).

    Per-task score = 100*acc + 100*acc+ where acc+ counts images with both
    questions right (calculation.py:109-160). Group totals sum task scores
    (Perception max 2000, Cognition max 800)."""
    out: Dict[str, dict] = {"tasks": {}, "perception": 0.0, "cognition": 0.0}
    for task, rows in task_results.items():
        assert len(rows) % 2 == 0, f"{task}: MME pairs two questions per image"
        gts = [gt.lower() for (_, gt, _) in rows]
        preds = [parse_pred_ans(p) for (_, _, p) in rows]
        for gt in gts:
            assert gt in ("yes", "no"), f"bad gt {gt!r}"
        metrics = _binary_metrics(gts, preds)
        plus = 0
        for i in range(0, len(rows), 2):
            if gts[i] == preds[i] and gts[i + 1] == preds[i + 1]:
                plus += 1
        metrics["acc_plus"] = plus / max(len(rows) // 2, 1)
        score = 100.0 * (metrics["acc"] + metrics["acc_plus"])
        metrics["score"] = score
        out["tasks"][task] = metrics
        if task in PERCEPTION_TASKS:
            out["perception"] += score
        elif task in COGNITION_TASKS:
            out["cognition"] += score
    out["total"] = out["perception"] + out["cognition"]
    return out
