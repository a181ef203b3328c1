"""MMBench option extraction + circular-consistency accuracy.

Letter extraction mirrors the reference's post_process
(eval/vlm/eval/mmbench/evaluate_mmbench.py:164-178). The reference exports
an xlsx for the official server; the circular rule implemented here is the
published MMBench protocol the server applies: every question appears in N
rotated-option variants (variant index = base_index + k*1e6) and an
instance counts as correct only if ALL its rotations are answered
correctly.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Sequence

CIRCULAR_OFFSET = 1_000_000


def extract_option_letter(pred: str, options: Dict[str, str]) -> str:
    """Free text -> option letter; empty -> 'C'; falls back to matching an
    option's content inside the prediction."""
    pred = pred.strip()
    letters = list(options.keys())
    if len(pred) == 1:
        return pred
    if len(pred) == 0:
        return "C"
    if pred[0] in letters:
        return pred[0]
    for k, v in options.items():
        if v and v in pred:
            return k
    return pred


def mmbench_accuracy(rows: Sequence[dict]) -> dict:
    """Plain per-row accuracy. rows: {'index', 'prediction', 'answer'
    [, 'category']}."""
    per_cat: Dict[str, list] = defaultdict(list)
    for r in rows:
        ok = str(r["prediction"]).strip().upper() == str(r["answer"]).strip().upper()
        per_cat[r.get("category", "all")].append(ok)
    cats = {k: sum(v) / len(v) for k, v in per_cat.items()}
    n = sum(len(v) for v in per_cat.values())
    overall = sum(sum(v) for v in per_cat.values()) / n if n else 0.0
    return {"overall": overall, "categories": cats, "num_example": n}


def mmbench_circular_accuracy(rows: Sequence[dict]) -> dict:
    """Circular evaluation: group rotated variants by index % 1e6; one
    logical question is correct iff every rotation is correct."""
    groups: Dict[int, list] = defaultdict(list)
    cat: Dict[int, Optional[str]] = {}
    for r in rows:
        base = int(r["index"]) % CIRCULAR_OFFSET
        ok = str(r["prediction"]).strip().upper() == str(r["answer"]).strip().upper()
        groups[base].append(ok)
        cat.setdefault(base, r.get("category", "all"))
    per_cat: Dict[str, list] = defaultdict(list)
    for base, oks in groups.items():
        per_cat[cat[base]].append(all(oks))
    cats = {k: sum(v) / len(v) for k, v in per_cat.items()}
    n = len(groups)
    overall = sum(sum(v) for v in per_cat.values()) / n if n else 0.0
    return {"overall": overall, "categories": cats, "num_questions": n}
