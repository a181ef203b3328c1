"""MMVP paired visual-pattern scoring (reference eval/vlm/eval/mmvp/
evaluate_mmvp.py).

MMVP asks two complementary questions per image pair; the published metric
credits a pair only when BOTH answers are right (evaluate_mmvp.py:197-214).
Predictions are free-form; the reference's post_process maps them onto the
option letters (evaluate_mmvp.py:124-136).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional


def extract_option(pred: str, options: Mapping[str, str]) -> str:
    """Map a free-form prediction to an option letter: a bare letter stands;
    a leading letter that IS an option stands; otherwise the first option
    whose text appears verbatim in the prediction wins; else the raw
    prediction (scored wrong unless it equals the gt letter)."""
    p = pred.strip()
    if len(p) == 1:
        return p
    if p and p[0] in options:
        return p[0]
    for letter, text in options.items():
        if text and text in p:
            return letter
    return p


def parse_options(option_field: str) -> Dict[str, str]:
    """Split the CSV's '(a) ... (b) ...' option string into {'A': ..., 'B':
    ...} (evaluate_mmvp.py:66-78)."""
    parts = option_field.split("(b)")
    letters = "ABCD"
    out = {}
    for i, part in enumerate(parts):
        out[letters[i]] = part.replace("(a)", "").replace("(b)", "").strip()
    return out


def normalize_gt(answer: str) -> str:
    """'(a)'/'(b)'... -> 'A'/'B'... (evaluate_mmvp.py:71)."""
    for low, up in (("(a)", "A"), ("(b)", "B"), ("(c)", "C"), ("(d)", "D")):
        answer = answer.replace(low, up)
    return answer


def mmvp_score(results: List[dict]) -> dict:
    """rows: {index, prediction, answer, options?} sorted by index; rows
    pair consecutively (the dataset interleaves the two questions of each
    pair). Returns pair accuracy (the published number) + per-question
    accuracy as a diagnostic."""
    rows = sorted(results, key=lambda r: _pair_key(r))
    q_correct = 0
    pair_correct = pairs = 0
    round_ok: Optional[bool] = None
    for i, r in enumerate(rows):
        opts = r.get("options") or {}
        pred = extract_option(r.get("prediction") or "", opts)
        ok = pred == normalize_gt(str(r["answer"]).strip())
        q_correct += ok
        if round_ok is None:
            round_ok = ok
        else:
            pairs += 1
            pair_correct += round_ok and ok
            round_ok = None
    return {
        "pair_accuracy": pair_correct / max(pairs, 1),
        "question_accuracy": q_correct / max(len(rows), 1),
        "pairs": pairs,
    }


def _pair_key(r: dict):
    # numeric data ids sort numerically ('10' after '9'); fall back to str
    idx = r.get("index", 0)
    try:
        return (0, int(idx))
    except (TypeError, ValueError):
        return (1, str(idx))
