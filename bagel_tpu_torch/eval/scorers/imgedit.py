"""ImgEdit-Bench scoring pipeline (reference eval/gen/imgedit/*).

Three stages, mirrored end-to-end around the pluggable judge:

1. judge pass (basic_bench.py): per-sample GPT call with the edit-type
   prompt template (prompts are loaded from the benchmark's prompts JSON and
   carry an `<edit_prompt>` placeholder, :29-55); resumable jsonl.
2. per-sample averaging (step1_get_avgscore.py): the judge responds with
   one "name: score" line per sub-dimension; the sample score is the mean
   of the integer-valued lines.
3. edit-type table (step2_typescore.py): mean per edit_type + overall.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional


def extract_scores_and_average(entry: str) -> Optional[float]:
    """Mean of the 'label: N' integer lines in one judge response
    (step1_get_avgscore.py:7-16)."""
    scores = []
    for line in entry.splitlines():
        parts = line.strip().split(": ")
        if len(parts) == 2 and parts[1].isdigit():
            scores.append(int(parts[1]))
    if scores:
        return round(sum(scores) / len(scores), 2)
    return None


def compute_averages(result_json: Dict[str, str]) -> Dict[str, float]:
    """{sample_key: judge_text} -> {sample_key: avg score}, dropping
    unparseable responses (step1_get_avgscore.py:18-24)."""
    out = {}
    for key, value in result_json.items():
        avg = extract_scores_and_average(value)
        if avg is not None:
            out[key] = avg
    return out


def compute_edit_type_averages(
    score_dict: Dict[str, float], meta_dict: Dict[str, dict]
) -> Dict[str, float]:
    """Published per-edit-type table + overall (step2_typescore.py:8-26).
    Samples whose meta lacks edit_type still count toward overall."""
    by_type = defaultdict(list)
    all_scores = []
    for key, score in score_dict.items():
        etype = meta_dict.get(key, {}).get("edit_type")
        if etype is not None:
            by_type[etype].append(score)
        all_scores.append(score)
    out = {
        etype: round(sum(v) / len(v), 2) for etype, v in by_type.items() if v
    }
    if all_scores:
        out["overall"] = round(sum(all_scores) / len(all_scores), 2)
    return out


def build_prompt(prompts: Dict[str, str], edit_type: str,
                 edit_prompt: str) -> str:
    """Edit-type template with the instruction substituted
    (basic_bench.py:37-38)."""
    return prompts[edit_type].replace("<edit_prompt>", edit_prompt)


def judge_edits(
    edit_meta: Dict[str, dict],
    prompts: Dict[str, str],
    judge: Callable[[str, List[str]], str],
    origin_of: Callable[[str, dict], str],
    result_of: Callable[[str, dict], str],
    out_path: Optional[str] = None,
) -> Dict[str, str]:
    """Stage-1 judge pass: {key: raw judge response}. Resumable via the
    appended jsonl at out_path (basic_bench.py:57-88); each call sees
    [original, edited] (:39-52)."""
    results: Dict[str, str] = {}
    if out_path and os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                rec = json.loads(line)
                results[rec["key"]] = rec["result"]
    fout = open(out_path, "a") if out_path else None
    try:
        for key, item in edit_meta.items():
            if key in results:
                continue
            prompt = build_prompt(prompts, item["edit_type"], item["prompt"])
            resp = judge(prompt, [origin_of(key, item), result_of(key, item)])
            results[key] = resp
            if fout:
                fout.write(json.dumps({"key": key, "result": resp}) + "\n")
                fout.flush()
    finally:
        if fout:
            fout.close()
    return results


def score_results(
    edit_meta: Dict[str, dict],
    prompts: Dict[str, str],
    judge: Callable[[str, List[str]], str],
    origin_of: Callable[[str, dict], str],
    result_of: Callable[[str, dict], str],
    out_path: Optional[str] = None,
) -> dict:
    """Full pipeline: judge -> per-sample averages -> edit-type table."""
    raw = judge_edits(edit_meta, prompts, judge, origin_of, result_of,
                      out_path)
    averages = compute_averages(raw)
    table = compute_edit_type_averages(averages, edit_meta)
    return {"per_sample": averages, "by_type": table,
            "n_failed": len(raw) - len(averages)}
