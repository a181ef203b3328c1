"""MathVista answer normalization + accuracy tables.

Reimplements the deterministic scoring half of the reference's
eval/vlm/eval/mathvista/calculate_score.py; the GPT answer-extraction stage
is a pluggable callable (use scorers.judge.run_judge with an extraction
prompt, or the offline regex fallback in vlm_runner.extract_number).
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence


def _edit_distance(a: str, b: str) -> int:
    """Levenshtein distance (the reference uses python-Levenshtein;
    MathVista choices are short so the plain DP is fine)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def most_similar_choice(prediction: str, choices: Sequence[str]) -> str:
    dists = [_edit_distance(prediction, c) for c in choices]
    return choices[dists.index(min(dists))]


def normalize_extracted_answer(
    extraction,
    choices: Sequence[str],
    question_type: str,
    answer_type: str,
    precision,
) -> Optional[str]:
    """calculate_score.py:30-77 semantics: multi-choice maps a letter (or
    nearest-edit-distance text) to choice text; integer/float/list answers
    are canonicalized as strings."""
    if question_type == "multi_choice":
        extraction = str(extraction).strip() if extraction is not None else ""
        letters = re.findall(r"\(([a-zA-Z])\)", extraction)
        if letters:
            extraction = letters[0].upper()
        options = [chr(ord("A") + i) for i in range(len(choices))]
        if extraction in options:
            return choices[options.index(extraction)]
        return most_similar_choice(extraction, list(choices))
    if answer_type == "integer":
        try:
            return str(int(float(extraction)))
        except (TypeError, ValueError):
            return None
    if answer_type == "float":
        try:
            return str(round(float(extraction), int(precision)))
        except (TypeError, ValueError):
            return None
    if answer_type == "list":
        try:
            return str(extraction)
        except Exception:
            return None
    return extraction


def mathvista_score(rows: Sequence[dict]) -> Dict:
    """rows: {'extraction', 'choices', 'question_type', 'answer_type',
    'precision', 'answer'[, breakdown keys e.g. 'task', 'skills']}.

    Returns overall accuracy + per-task / per-skill tables (skills rows hold
    lists; a row counts toward each skill)."""
    total = correct = 0
    by: Dict[str, Dict[str, List[bool]]] = defaultdict(lambda: defaultdict(list))
    for r in rows:
        pred = normalize_extracted_answer(
            r.get("extraction"), r.get("choices") or [],
            r["question_type"], r.get("answer_type", ""),
            r.get("precision", 0),
        )
        ok = pred is not None and pred == str(r["answer"])
        total += 1
        correct += ok
        for key in ("task", "grade", "context", "category"):
            if key in r:
                by[key][str(r[key])].append(ok)
        for skill in r.get("skills", []):
            by["skills"][skill].append(ok)
    out = {
        "accuracy": correct / max(total, 1),
        "total": total,
        "correct": correct,
    }
    for key, table in by.items():
        out[key] = {k: sum(v) / len(v) for k, v in table.items()}
    return out


# ---------------------------------------------------------------------------
# GPT answer-extraction stage (extract_answer.py:24-95): type shortcuts,
# optional quick regex, then a pluggable judge formatted with the published
# few-shot demo prompt (prompts/ext_ans.py)
# ---------------------------------------------------------------------------

# few-shot demos showing "Extracted answer: <x>" for each answer type; pass
# the canonical prompts/ext_ans.py text via demo_prompt= for byte parity
DEFAULT_DEMO_PROMPT = """\
Please read the following example. Then extract the answer from the model \
response and type it at the end of the prompt.

Hint: Please answer the question requiring an integer answer and provide \
the final value at the end.
Question: Which number is missing?

Model response: The number missing in the sequence is 14.

Extracted answer: 14

Hint: Please answer the question with a multiple-choice letter and provide \
the letter at the end.
Question: What is the shape shown? Choices: (A) circle (B) square

Model response: The shape is a square.

Extracted answer: (B) square"""


def _final_answer(text: str) -> str:
    m = re.search(r"(Final answer:|Answer:)\s*(.*)", text, re.IGNORECASE)
    return m.group(2).strip() if m else text


def create_test_prompt(demo_prompt: str, query: str, response: str) -> str:
    """extract_answer.py:31-35."""
    return (f"{demo_prompt.strip()}\n\n{query}\n\n{response}"
            "\n\nExtracted answer: ")


def extract_answer_with_judge(
    response: str,
    problem: dict,
    judge=None,
    quick_extract: bool = False,
    demo_prompt: str = DEFAULT_DEMO_PROMPT,
) -> str:
    """Extraction cascade (extract_answer.py:45-95): verbatim-choice and
    int/float shortcuts, optional quick 'Answer:' regex, then the judge
    (judge(prompt, []) -> extracted text); '' when nothing applies and no
    judge is available."""
    question_type = problem.get("question_type")
    answer_type = problem.get("answer_type")
    choices = problem.get("choices") or []
    if response == "":
        return ""
    if question_type == "multi_choice" and response in choices:
        return response
    if answer_type == "integer":
        try:
            return str(int(response))
        except (TypeError, ValueError):
            pass
    if answer_type == "float":
        try:
            return str(float(response))
        except (TypeError, ValueError):
            pass
    if quick_extract:
        try:
            return _final_answer(response)
        except Exception:
            pass
    if judge is not None:
        try:
            return judge(
                create_test_prompt(demo_prompt, problem.get("query", ""),
                                   response),
                [],
            ).strip()
        except Exception:
            return ""
    return ""
