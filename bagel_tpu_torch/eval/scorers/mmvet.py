"""MM-Vet integrated-capability scoring.

The reference runner (eval/vlm/eval/mmvet/evaluate_mmvet.py:59-86) only
exports ``results.json`` keyed ``v1_{question_id}`` for the official MM-Vet
GPT-4 grader; the grading itself lives in the public MM-Vet evaluator.
This module covers both halves:

  - ``export_results`` writes the exact format the official grader ingests;
  - ``mmvet_score`` runs the published grading protocol in-process over an
    injected judge callable (scorers/judge.run_judge-compatible): the
    few-shot correctness prompt, ``<AND>``/``<OR>`` ground-truth semantics,
    0.0-1.0 score extraction, mean over judge runs, and the per-capability
    breakdown (a sample counts toward every capability tag it carries,
    e.g. "rec,ocr,spat").

Without a judge, a deterministic containment fallback applies the
``<AND>``/``<OR>`` algebra directly (normalized substring match) — an
offline lower bound, clearly labeled in the output.
"""

from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, Optional

_GRADER_PREAMBLE = (
    "Compare the ground truth and prediction from AI models, to give a "
    "correctness score for the prediction. <AND> in the ground truth means "
    "it is totally right only when all elements in the ground truth are "
    "present in the prediction, and <OR> means it is totally right when "
    "any one element in the ground truth is present in the prediction. The "
    "correctness score is 0.0 (totally wrong), 0.1, 0.2, 0.3, 0.4, 0.5, "
    "0.6, 0.7, 0.8, 0.9, or 1.0 (totally right). Just complete the last "
    "space of the correctness score."
)

# few-shot anchors from the published grader: calibrate partial credit
_FEWSHOT = (
    ("What is x in the equation?", "-1 <AND> -5",
     "x = 3", "0.0"),
    ("What is x in the equation?", "-1 <AND> -5",
     "x = -1", "0.5"),
    ("What is x in the equation?", "-1 <AND> -5",
     "x = -5", "0.5"),
    ("What is x in the equation?", "-1 <AND> -5",
     "x = -1 or 5", "0.5"),
    ("What is x in the equation?", "-1 <AND> -5",
     "x = -1 or x = -5", "1.0"),
    ("Can you explain this meme?",
     "This meme is poking fun at the fact that the names of the countries "
     "Iceland and Greenland are misleading. <OR> The meme talks about "
     "Iceland and Greenland.",
     "The meme talks about Iceland and Greenland.", "1.0"),
)


def build_grader_prompt(question: str, gt: str, prediction: str) -> str:
    rows = [_GRADER_PREAMBLE, "", "Question | Ground truth | Prediction | "
            "Correctness", "--- | --- | --- | ---"]
    for q, g, p, s in _FEWSHOT:
        rows.append(f"{q} | {g} | {p} | {s}")
    pred = prediction.replace("|", " ").replace("\n", " ")
    rows.append(f"{question} | {gt} | {pred} | ")
    return "\n".join(rows)


_SCORE_RE = re.compile(r"(?:^|[^\d.])(1\.0|0?\.\d|0|1)(?:$|[^\d])")


def parse_grader_score(text: str) -> Optional[float]:
    """First 0.0-1.0 literal in the judge reply; None if absent."""
    m = _SCORE_RE.search(text.strip())
    if not m:
        return None
    v = float(m.group(1))
    return v if 0.0 <= v <= 1.0 else None


def _norm(s: str) -> str:
    return re.sub(r"\s+", " ", s.lower().strip().strip("."))


def containment_score(gt: str, prediction: str) -> float:
    """Offline fallback: the <AND>/<OR> algebra as normalized substring
    containment. <AND> scores the satisfied fraction (matching the
    published few-shot anchors: one of two elements -> 0.5)."""
    pred = _norm(prediction)
    or_parts = [p.strip() for p in gt.split("<OR>")]

    def and_score(part: str) -> float:
        elems = [_norm(e) for e in part.split("<AND>") if e.strip()]
        if not elems:
            return 0.0
        return sum(e in pred for e in elems) / len(elems)

    return max((and_score(p) for p in or_parts), default=0.0)


def mmvet_score(
    results: List[dict],
    judge: Optional[Callable[[str], str]] = None,
    runs: int = 1,
) -> Dict:
    """rows: {index, question, answer (gt with <AND>/<OR>), prediction,
    capability? ('rec,ocr'-style tag list)}. judge: prompt -> reply text.
    Returns total + per-capability + per-capability-combination means
    (x100, the published table units)."""
    per_cap: Dict[str, List[float]] = {}
    per_combo: Dict[str, List[float]] = {}
    scores = []
    for r in results:
        gt = str(r.get("answer") or "")
        pred = r.get("prediction") or ""
        if judge is not None:
            vals = []
            for _ in range(max(runs, 1)):
                reply = judge(build_grader_prompt(
                    r.get("question") or "", gt, pred))
                v = parse_grader_score(reply or "")
                if v is not None:
                    vals.append(v)
            score = sum(vals) / len(vals) if vals else 0.0
        else:
            score = containment_score(gt, pred)
        scores.append(score)
        caps = [c.strip() for c in str(r.get("capability") or "").split(",")
                if c.strip()]
        for c in caps:
            per_cap.setdefault(c, []).append(score)
        if caps:
            per_combo.setdefault(",".join(sorted(caps)), []).append(score)
    out = {
        "total": 100.0 * sum(scores) / max(len(scores), 1),
        "samples": len(scores),
        "graded_by": "judge" if judge is not None else
                     "containment_fallback",
    }
    for c, v in sorted(per_cap.items()):
        out[f"cap/{c}"] = 100.0 * sum(v) / len(v)
    for c, v in sorted(per_combo.items()):
        out[f"combo/{c}"] = 100.0 * sum(v) / len(v)
    return out


def export_results(results: List[dict], path: str) -> None:
    """The reference's official-grader handoff format:
    {"v1_{question_id}": prediction} (evaluate_mmvet.py:81-85)."""
    payload = {
        f"v1_{r.get('question_id', r.get('index'))}": r.get("prediction")
        or ""
        for r in results
    }
    with open(path, "w") as f:
        json.dump(payload, f)
