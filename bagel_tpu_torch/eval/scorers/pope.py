"""POPE yes/no F1 (reference eval/vlm/eval/pope/eval_pope.py).

First-sentence negation sniff -> binary label; reports accuracy, precision,
recall, F1 and the yes-ratio diagnostic.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def parse_yes_no(text: str) -> str:
    """Keep the first sentence; 'No'/'no'/'not' anywhere in it means 'no'
    (eval_pope.py:21-32)."""
    if "." in text:
        text = text.split(".")[0]
    words = text.replace(",", "").split(" ")
    if "No" in words or "not" in words or "no" in words:
        return "no"
    return "yes"


def pope_score(pairs: Sequence[Tuple[str, str]]) -> dict:
    """pairs: [(gt_label, raw_prediction)] with gt in {'yes','no'}."""
    preds = [1 if parse_yes_no(p) == "yes" else 0 for (_, p) in pairs]
    gts = [1 if g == "yes" else 0 for (g, _) in pairs]
    tp = sum(1 for p, g in zip(preds, gts) if p == 1 and g == 1)
    fp = sum(1 for p, g in zip(preds, gts) if p == 1 and g == 0)
    tn = sum(1 for p, g in zip(preds, gts) if p == 0 and g == 0)
    fn = sum(1 for p, g in zip(preds, gts) if p == 0 and g == 1)
    n = max(len(pairs), 1)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return {
        "TP": tp, "FP": fp, "TN": tn, "FN": fn,
        "accuracy": (tp + tn) / n,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "yes_ratio": sum(preds) / n,
    }
