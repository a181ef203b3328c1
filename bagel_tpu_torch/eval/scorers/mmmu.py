"""MMMU answer parsing + accuracy (reference eval/vlm/eval/mmmu/eval_utils.py).

Multi-choice: extract the chosen letter from free text — bracketed '(A)',
bare ' A ', or option-content containment for long responses; ties broken by
last occurrence. Open: split the response into key sub-answers after
indicator phrases, extract numbers, normalize, and match against golds.
"""

from __future__ import annotations

import random
import re
from collections import defaultdict
from typing import Dict, List, Sequence, Union


def parse_multi_choice_response(
    response: str,
    all_choices: Sequence[str],
    index2ans: Dict[str, str],
    rng: random.Random = None,
) -> str:
    """Returns the predicted option letter (eval_utils.py:22-74)."""
    for ch in (",", ".", "!", "?", ";", ":", "'"):
        response = response.strip(ch)
    response = f" {response} "

    index_ans = True
    with_brackets = False
    candidates: List[str] = []
    for c in all_choices:
        if f"({c})" in response:
            candidates.append(c)
            with_brackets = True
    if not candidates:
        for c in all_choices:
            if f" {c} " in response:
                candidates.append(c)
    if not candidates and len(response.split()) > 5:
        for idx, ans in index2ans.items():
            if ans.lower() in response.lower():
                candidates.append(idx)
                index_ans = False
    if not candidates:
        return (rng or random).choice(list(all_choices))
    if len(candidates) == 1:
        return candidates[0]
    # multiple hits: take the one mentioned last
    def last_pos(c):
        if not index_ans:
            return response.lower().rfind(index2ans[c].lower())
        return response.rfind(f"({c})" if with_brackets else f" {c} ")

    return max(candidates, key=last_pos)


def _is_number(s: str) -> bool:
    try:
        float(s.replace(",", ""))
        return True
    except ValueError:
        return False


def normalize_str(s: str) -> List[Union[str, float]]:
    """Numbers -> rounded floats; 1-char strings -> space-guarded variants
    (eval_utils.py:89-110)."""
    s = s.strip()
    if _is_number(s):
        return [round(float(s.replace(",", "")), 2)]
    s = s.lower()
    if len(s) == 1:
        return [f" {s}", f"{s} "]
    return [s]


_NUM_COMMAS = r"-?\b\d{1,3}(?:,\d{3})+\b"
_NUM_SCI = r"-?\d+(?:\.\d+)?[eE][+-]?\d+"
_NUM_SIMPLE = r"-?(?:\d+\.\d+|\.\d+|\d+\b)(?![eE][+-]?\d+)(?![,\d])"


def extract_numbers(s: str) -> List[str]:
    return (
        re.findall(_NUM_COMMAS, s)
        + re.findall(_NUM_SCI, s)
        + re.findall(_NUM_SIMPLE, s)
    )


_KEY_INDICATORS = (
    "could be ", "so ", "is ", "thus ", "therefore ", "final ",
    "answer ", "result ",
)


def parse_open_response(response: str) -> List[Union[str, float]]:
    """Candidate answers from a free-form response (eval_utils.py:138-190)."""
    text = response.strip().strip(".").lower()
    subs = re.split(r"\.\s(?=[A-Z])|\n", text)
    keys: List[str] = []
    for i, sub in enumerate(subs):
        indicators = list(_KEY_INDICATORS) + (["="] if i == len(subs) - 1 else [])
        shortest = None
        for ind in indicators:
            if ind in sub:
                tail = sub.split(ind)[-1].strip()
                if shortest is None or len(tail) < len(shortest):
                    shortest = tail
        if shortest and shortest.strip() not in (":", ",", ".", "!", "?", ";", "'"):
            keys.append(shortest)
    if not keys:
        keys = [text]
    preds: List[str] = list(keys)
    for k in keys:
        preds.extend(extract_numbers(k))
    out: List[Union[str, float]] = []
    for p in preds:
        out.extend(normalize_str(p))
    return list(dict.fromkeys(out))  # dedupe, keep order


def eval_multi_choice(gold: Union[str, List[str]], pred: str) -> bool:
    golds = gold if isinstance(gold, list) else [gold]
    return pred in golds


def eval_open_response(
    gold: Union[str, List[str]], preds: List[Union[str, float]]
) -> bool:
    golds = gold if isinstance(gold, list) else [gold]
    norm: List[Union[str, float]] = []
    for g in golds:
        norm.extend(normalize_str(g))
    for p in preds:
        if isinstance(p, str):
            if any(isinstance(n, str) and n in p for n in norm):
                return True
        elif p in norm:
            return True
    return False


def mmmu_accuracy(samples: Sequence[dict]) -> dict:
    """samples: {'id', 'subject', 'question_type', 'answer',
    'parsed_pred'} -> per-subject accuracies + instruction-level overall
    (eval_utils.py:239-275)."""
    per_subject: Dict[str, List[bool]] = defaultdict(list)
    for s in samples:
        if s["question_type"] == "multiple-choice":
            ok = eval_multi_choice(s["answer"], s["parsed_pred"])
        else:
            ok = eval_open_response(s["answer"], s["parsed_pred"])
        per_subject[s.get("subject", "all")].append(ok)
    subjects = {
        k: {"acc": sum(v) / len(v), "num_example": len(v)}
        for k, v in per_subject.items()
    }
    total = sum(r["num_example"] for r in subjects.values())
    overall = (
        sum(r["acc"] * r["num_example"] for r in subjects.values()) / total
        if total else 0.0
    )
    return {"subjects": subjects, "overall_acc": overall, "num_example": total}


# ---------------------------------------------------------------------------
# CoT variant + published domain table (evaluate_mmmu_cot.py,
# main_eval_only.py, data_utils.py:20-62)
# ---------------------------------------------------------------------------

DOMAIN_CAT2SUB_CAT = {
    "Art and Design": ["Art", "Art_Theory", "Design", "Music"],
    "Business": ["Accounting", "Economics", "Finance", "Manage", "Marketing"],
    "Science": ["Biology", "Chemistry", "Geography", "Math", "Physics"],
    "Health and Medicine": [
        "Basic_Medical_Science", "Clinical_Medicine",
        "Diagnostics_and_Laboratory_Medicine", "Pharmacy", "Public_Health",
    ],
    "Humanities and Social Science": [
        "History", "Literature", "Sociology", "Psychology",
    ],
    "Tech and Engineering": [
        "Agriculture", "Architecture_and_Engineering", "Computer_Science",
        "Electronics", "Energy_and_Power", "Materials",
        "Mechanical_Engineering",
    ],
}

# the CoT run instructs "Final Answer: <answer>" after optional
# <think></think> reasoning (evaluate_mmmu_cot.py:49-67)
_THINK_RE = re.compile(r"<think>.*?</think>", re.DOTALL)
_FINAL_RE = re.compile(r"final\s+answer\s*[:：]\s*(.*)", re.IGNORECASE)


def extract_cot_answer(response: str) -> str:
    """Strip the <think> block and return the text after 'Final Answer:'
    (falling back to the whole remainder when the model skipped the
    format) — the CoT preprocessing before the standard parsers."""
    text = _THINK_RE.sub("", response).strip()
    m = _FINAL_RE.search(text)
    return m.group(1).strip() if m else text


def subject_of_data_id(data_id: str) -> str:
    """'validation_Computer_Science_12' -> 'Computer_Science'
    (main_eval_only.py:35)."""
    return "_".join(data_id.split("_")[1:-1])


def mmmu_domain_table(samples: Sequence[dict]) -> dict:
    """Published printable table: per-subject rows, 'Overall-<domain>'
    instruction-level rows, and Overall (main_eval_only.py:75-116).

    samples as mmmu_accuracy, with 'subject' set (use subject_of_data_id
    for raw data_ids; extract_cot_answer + the parse_* functions for CoT
    responses)."""
    base = mmmu_accuracy(samples)
    table = {}
    for domain, cats in DOMAIN_CAT2SUB_CAT.items():
        rows = {c: base["subjects"][c] for c in cats
                if c in base["subjects"]}
        if not rows:
            continue
        num = sum(r["num_example"] for r in rows.values())
        acc = sum(r["acc"] * r["num_example"] for r in rows.values()) / num
        table[f"Overall-{domain}"] = {"num": num, "acc": round(acc, 3)}
        for c, r in rows.items():
            table[c] = {"num": r["num_example"], "acc": round(r["acc"], 3)}
    table["Overall"] = {"num": base["num_example"],
                        "acc": round(base["overall_acc"], 3)}
    return table
