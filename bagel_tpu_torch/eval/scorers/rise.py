"""RISEBench scoring pipeline (reference eval/gen/rise/gpt_eval.py, 545 LoC).

Reimplements the published metric around a pluggable judge: per-category
judge planning (which of consistency / reasoning / quality calls a sample
needs and which images each call sees, gpt_eval.py:146-255), the
"Final Score" extraction regexes (:258-280), the score-vector assembly
incl. the two-judge 1..5 remap (:430-446), the weighted sample score and
completion rules (:283-305) and the per-task / per-subtask accuracy tables
(:360-520). RISEBench's headline number is the completion (accuracy) rate.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional

SUBTASKS = {
    "Temp": [
        "Life Progression", "Material Progression", "Environmental Cycles",
        "Societal Transformation",
    ],
    "Causal": [
        "Structural Deformation", "State Transition",
        "Chemical and Biological Transformation", "Physics Manifestation",
    ],
    "Spa": [
        "Component Assembly", "Object Arrangement", "Viewpoint Generation",
        "Structural Inference", "Layout Reasoning",
    ],
    "Logic": [
        "Pattern Prediction", "Mathematical Derivation", "Puzzle Solving",
    ],
}

THREE_JUDGE_CATEGORIES = (
    "temporal_reasoning", "causal_reasoning", "spatial_reasoning",
)


def extract_final_scores(answer: str) -> Optional[List[int]]:
    """Parse the judge's '**Final Score**: n [m ...]' line (gpt_eval.py
    extract(): 'Final Score' first, then 'Final Scores')."""
    for label in ("Final Score", "Final Scores"):
        matches = re.findall(
            r"\*?\*?" + label + r"\*?\*?:?\s*([\d*\s,\n]*)", answer,
            re.IGNORECASE,
        )
        numbers: List[int] = []
        for match in matches:
            found = re.findall(r"\d+", match.replace("\n", " "))
            if found:
                numbers.extend(int(x) for x in found)
                break
        if numbers:
            return numbers
        if label == "Final Scores" and matches:
            return numbers or None
    return None


def plan_judges(item: dict) -> dict:
    """Which judge calls one sample needs (gpt_eval.py eval_vanilla).

    item keys: category, plus the flags the metadata carries
    (consistency_free, reference_img, reference_txt, reasoning_img,
    reasoning_wo_ins). Returns {"consistency": bool, "quality": bool,
    "reasoning_with_input": bool, "prompt_keys": {...}} — prompt_keys name
    which prompt template each call uses so a caller with the canonical
    prompt set can format them."""
    cat = item["category"]
    has = lambda k: item.get(k) not in (None, "", False)  # noqa: E731
    plan = {
        "consistency": not has("consistency_free"),
        "quality": cat in THREE_JUDGE_CATEGORIES,
        "reasoning_with_input": False,
        "prompt_keys": {},
    }
    pk = plan["prompt_keys"]
    if cat in ("temporal_reasoning", "causal_reasoning"):
        if has("reference_img") and has("reasoning_img"):
            plan["reasoning_with_input"] = True
            pk["reasoning"] = "reasoning_w_input"
        else:
            pk["reasoning"] = "reasoning"
        pk["consistency"] = "consist"
        pk["quality"] = "generation"
    elif cat == "spatial_reasoning":
        if has("reference_img"):
            plan["reasoning_with_input"] = True
            pk["reasoning"] = "spatial_ref_img"
        elif has("reasoning_img"):
            plan["reasoning_with_input"] = True
            pk["reasoning"] = "spatial_ref_w_input"
        else:
            pk["reasoning"] = "spatial_ref"
        pk["consistency"] = "spatial_cons"
        pk["quality"] = "spatial_qual"
    elif cat == "logical_reasoning":
        if has("reference_txt"):
            pk["consistency"] = "logical_cons_ans"
            pk["reasoning"] = "logical_txt"
        else:
            pk["consistency"] = "logical_cons"
            plan["reasoning_with_input"] = True
            pk["reasoning"] = (
                "logical_img_wo_q" if has("reasoning_wo_ins")
                else "logical_img"
            )
    else:
        raise ValueError(f"unknown RISE category {cat!r}")
    return plan


def assemble_scores(category: str, judge1: Optional[str],
                    judge2: Optional[str],
                    judge3: Optional[str]) -> Optional[dict]:
    """judge responses -> {ApprConsistency, Reasoning, VisualPlausibility}
    (gpt_eval.py:369-446). judge1=consistency, judge2=reasoning,
    judge3=quality; judge1 None = consistency_free sample. Returns None on
    extraction failure (match_log 'failed')."""
    if judge1 is None:
        s2, s3 = extract_final_scores(judge2 or ""), extract_final_scores(
            judge3 or "")
        if not s2 or not s3:
            return None
        return {"ApprConsistency": None, "Reasoning": s2[0],
                "VisualPlausibility": s3[0]}
    if judge3 is None:
        s1, s2 = extract_final_scores(judge1 or ""), extract_final_scores(
            judge2 or "")
        if not s1 or not s2:
            return None
        # two-judge categories score 0/1-style judgments remapped onto the
        # 1..5 scale: 4*min(s,1)+1 (gpt_eval.py:437-439)
        return {
            "ApprConsistency": 4 * min(s1[0], 1) + 1,
            "Reasoning": 4 * min(s2[0], 1) + 1,
            "VisualPlausibility": None,
        }
    s1 = extract_final_scores(judge1 or "")
    s2 = extract_final_scores(judge2 or "")
    s3 = extract_final_scores(judge3 or "")
    if not s1 or not s2 or not s3:
        return None
    return {"ApprConsistency": s1[0], "Reasoning": s2[0],
            "VisualPlausibility": s3[0]}


def sample_score(category: str, scores: dict,
                 consistency_free: bool = False) -> float:
    """Weighted 1-5 sample score (gpt_eval.py calculate_score)."""
    if category in THREE_JUDGE_CATEGORIES:
        if consistency_free:
            score = (0.2 * scores["VisualPlausibility"]
                     + 0.8 * scores["Reasoning"])
        else:
            score = (0.3 * scores["ApprConsistency"]
                     + 0.5 * scores["Reasoning"]
                     + 0.2 * scores["VisualPlausibility"])
    elif category == "logical_reasoning":
        score = 0.3 * scores["ApprConsistency"] + 0.7 * scores["Reasoning"]
    else:
        raise ValueError(category)
    if scores["Reasoning"] == 1:
        score = score * 0.5
        score = 1 if score < 1 else score
    return score


def sample_complete(category: str, scores: dict) -> int:
    """Completion indicator: all judged dimensions at 5
    (gpt_eval.py calculate_completion)."""
    if category in THREE_JUDGE_CATEGORIES:
        return int(
            scores["ApprConsistency"] == 5 and scores["Reasoning"] == 5
            and scores["VisualPlausibility"] == 5
        )
    return int(scores["ApprConsistency"] == 5 and scores["Reasoning"] == 5)


def to_percent(s: float) -> float:
    """1-5 score -> 0-100 (gpt_eval.py trans_to_percent)."""
    return 25 * (s - 1)


def summarize(rows: Iterable[dict]) -> dict:
    """Published RISE tables from judged rows.

    rows: {category, subtask, scores: {ApprConsistency, Reasoning,
    VisualPlausibility} | None, consistency_free?}. Returns overall /
    per-main-task / per-subtask mean score (raw + percent) and completion
    (accuracy) rates; failed rows (scores None) are excluded from the means
    like the reference's NaN columns."""
    rows = list(rows)
    scored = []
    for r in rows:
        if r.get("scores") is None:
            continue
        cf = bool(r.get("consistency_free"))
        s = sample_score(r["category"], r["scores"], cf)
        scored.append({**r, "score": s,
                       "complete": sample_complete(r["category"], r["scores"])})

    def stats(sel):
        if not sel:
            return None
        score = sum(x["score"] for x in sel) / len(sel)
        return {
            "score": score,
            "score_percent": to_percent(score),
            "accuracy": sum(x["complete"] for x in sel) / len(sel),
            "n": len(sel),
        }

    by_cat = defaultdict(list)
    by_sub = defaultdict(list)
    for x in scored:
        by_cat[x["category"]].append(x)
        if x.get("subtask"):
            by_sub[x["subtask"]].append(x)

    subtask_table = {}
    for prefix, subs in SUBTASKS.items():
        for sub in subs:
            if sub in by_sub:
                subtask_table[sub] = stats(by_sub[sub])
    out = {
        "overall": stats(scored),
        "categories": {c: stats(v) for c, v in by_cat.items()},
        "subtasks": subtask_table,
        "n_failed": sum(1 for r in rows if r.get("scores") is None),
    }
    return out


def score_results(
    items: Iterable[dict],
    judge: Callable[[str, List[str]], str],
    prompts: Dict[str, str],
    image_of: Callable[[dict], str],
    input_image_of: Callable[[dict], str],
) -> dict:
    """End-to-end: plan judges per item, call, assemble, summarize.

    items carry the RISE metadata fields (category, subtask, instruction,
    reference*, consistency_free, ...); prompts maps the plan's prompt_keys
    (consist, reasoning, spatial_ref, logical_cons, generation, ...) to
    template strings formatted with {instruct} / {reference}."""
    rows = []
    for item in items:
        plan = plan_judges(item)
        fmt = dict(instruct=item.get("instruction", ""),
                   reference=item.get("reference", ""))
        img_in, img_out = input_image_of(item), image_of(item)

        def render(key):
            return prompts[plan["prompt_keys"][key]].format(**{
                k: v for k, v in fmt.items()
                if "{" + k + "}" in prompts[plan["prompt_keys"][key]]
            })

        j1 = (judge(render("consistency"), [img_in, img_out])
              if plan["consistency"] else None)
        rea_imgs = [img_in, img_out] if plan["reasoning_with_input"] else [img_out]
        j2 = judge(render("reasoning"), rea_imgs)
        j3 = (judge(render("quality"), [img_out]) if plan["quality"] else None)
        rows.append({
            **{k: item.get(k) for k in ("category", "subtask",
                                        "consistency_free")},
            "scores": assemble_scores(item["category"], j1, j2, j3),
        })
    return summarize(rows)
