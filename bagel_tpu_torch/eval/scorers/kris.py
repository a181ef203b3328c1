"""KRIS-Bench metric pipeline (reference eval/gen/kris/*).

The reference ships five GPT-judged metric workers (metrics_common.py,
metrics_knowledge.py, metrics_multi_element.py, metrics_temporal_prediction
.py, metrics_view_change.py) plus a summarizer (summarize.py). This module
reimplements the full pipeline around the repo's pluggable judge
(`eval/scorers/judge.py: run_judge`): category→metric routing, prompt
selection, score extraction (JSON-first with regex fallback,
metrics_common.py:173-232; dual-score block extraction,
metrics_knowledge.py:206-262) and the published aggregation tables
(summarize.py:10-162) — all unit-testable with a canned judge.

Prompt texts: the canonical judge prompts (reference prompts.py,
Apache-2.0, from mercurystraw/Kris_Bench) are VENDORED under
eval/prompts/kris/ and loaded as the defaults — no `prompts=` needed to
reproduce the published operating point byte-for-byte (`quality` is sent
unformatted, preserving the reference's literal {{ }} quirk). The inline
paraphrases below remain the fallback when a vendored file is missing,
and `prompts=` still overrides per key.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional

# --- published benchmark structure (summarize.py:10-80) ---------------------

KRIS_BENCHMARK_TYPE = {
    "Attribute Perception": [
        "count_change", "color_change", "size_adjustment",
        "part_completion", "anomaly_correction",
    ],
    "Spatial Perception": ["viewpoint_change", "position_movement"],
    "Temporal Prediction": ["temporal_prediction"],
    "Social Science": ["humanities", "practical_knowledge"],
    "Natural Science": [
        "biology", "chemistry", "geography", "medicine", "mathematics",
        "physics",
    ],
    "Logical Reasoning": ["abstract_reasoning", "rule-based_reasoning"],
    "Instruction Decomposition": [
        "multi-element_composition", "multi-instruction_execution",
    ],
}

_KNOWLEDGE_TYPES = {"Social Science", "Natural Science", "Logical Reasoning"}

KRIS_BENCHMARK_METRIC = {
    t: (
        ["consistency_score", "quality_score", "instruction_score",
         "knowledge_score"]
        if t in _KNOWLEDGE_TYPES
        else ["consistency_score", "quality_score", "instruction_score"]
    )
    for t in KRIS_BENCHMARK_TYPE
}

META_CATEGORIES = {
    "Factual Knowledge": [
        "Attribute Perception", "Spatial Perception", "Temporal Prediction",
    ],
    "Conceptual Knowledge": ["Social Science", "Natural Science"],
    "Procedural Knowledge": [
        "Logical Reasoning", "Instruction Decomposition",
    ],
}

SCORE_SHORT_NAME = {
    "consistency_score": "VC",
    "quality_score": "VQ",
    "instruction_score": "IF",
    "knowledge_score": "KP",
    "average_score": "AVG",
}
SCORE_ORDER = [
    "consistency_score", "quality_score", "instruction_score",
    "knowledge_score", "average_score",
]

# per-category worker routing: which judge calls a sample needs
# (metrics_common.py METRICS vs metrics_knowledge.py "dual_score")
KNOWLEDGE_CATEGORIES = {
    sub for t in _KNOWLEDGE_TYPES for sub in KRIS_BENCHMARK_TYPE[t]
}


def category_type(category: str) -> Optional[str]:
    for t, subs in KRIS_BENCHMARK_TYPE.items():
        if category in subs:
            return t
    return None


def metrics_for_category(category: str) -> List[str]:
    """Judge calls for one sample: knowledge categories replace the plain
    instruction metric with the dual instruction+knowledge evaluation
    (metrics_knowledge.py:151)."""
    if category in KNOWLEDGE_CATEGORIES:
        return ["consistency", "dual_score", "image_quality"]
    return ["consistency", "instruction_following", "image_quality"]


# --- default judge prompts (rubric-equivalent; canonical wording in the
# reference's prompts.py — pass prompts= to override) ------------------------

DEFAULT_PROMPTS = {
    "consistency": (
        "You are shown an original image and an edited image produced for "
        "the instruction: \"{instruct}\". Rate on a 1-5 scale how well the "
        "edited image PRESERVES everything the instruction did not ask to "
        "change (identity, layout, background, style). 5 = perfect "
        "preservation, 1 = unrelated image. Respond in JSON: "
        '{{"consistency_score": <1-5>, "reason": "..."}}'
    ),
    "instruction_following": (
        "You are shown an original image and an edited image produced for "
        "the instruction: \"{instruct}\". Rate on a 1-5 scale how "
        "completely and precisely the edit EXECUTES the instruction. 5 = "
        "fully executed, 1 = not executed. Respond in JSON: "
        '{{"instruction_score": <1-5>, "reasoning": "..."}}'
    ),
    "abnormal_instruction_following": (
        "You are shown an original image containing an anomaly and an "
        "edited image produced for the correction instruction: "
        "\"{instruct}\". The expected correction is: \"{explanation}\". "
        "Rate on a 1-5 scale how well the edit corrects the anomaly. "
        'Respond in JSON: {{"instruction_score": <1-5>, "reasoning": "..."}}'
    ),
    "image_quality": (
        "Rate the overall visual quality of this image on a 1-5 scale "
        "(artifacts, coherence, sharpness). Respond in JSON: "
        '{{"quality_score": <1-5>, "reasoning": "..."}}'
    ),
    "dual_score": (
        "You are shown an original image and an edited image produced for "
        "the instruction: \"{instruct}\". The relevant knowledge is: "
        "\"{explanation}\". Rate two things on 1-5 scales: "
        "instruction_score (how completely the edit executes the "
        "instruction) and knowledge_score (how correctly the edit applies "
        "the required knowledge). Respond in JSON: "
        '{{"instruction_score": <1-5>, "instruction_reasoning": "...", '
        '"knowledge_score": <1-5>, "knowledge_reasoning": "..."}}'
    ),
}

# canonical reference prompt bytes take precedence over the paraphrases
try:
    from bagel_tpu_torch.eval.prompts import kris_defaults as _kris_canonical

    DEFAULT_PROMPTS.update(_kris_canonical())
except Exception:  # vendored data missing: paraphrases stand
    pass


# --- extraction (metrics_common.py:173-232) ---------------------------------

_DEFAULT_PATTERNS = [
    r"([1-5])\s*/\s*5",
    r"([1-5])\s+out\s+of\s+5",
    r"\b([1-5])\b",
]


def _extract_json_field(response: str, score_key: str, reason_key: str):
    pattern = r"\{[^{}]*" + re.escape(score_key) + r"[^{}]*\}"
    match = re.search(pattern, response, re.DOTALL)
    if not match:
        return None, None
    try:
        data = json.loads(match.group(0))
        score = data.get(score_key)
        return (int(score) if score is not None else None,
                data.get(reason_key))
    except Exception:
        return None, None


def extract_score_and_reason(response, score_key, reason_fields,
                             prefix_patterns=None):
    """JSON-first, regex-fallback score extraction."""
    for rf in reason_fields:
        score, reason = _extract_json_field(response, score_key, rf)
        if score is not None:
            return score, reason
    for pat in (prefix_patterns or []) + _DEFAULT_PATTERNS:
        m = re.search(pat, response, re.IGNORECASE | re.DOTALL)
        if m:
            return int(m.group(1)), None
    return None, None


def extract_consistency(response: str):
    return extract_score_and_reason(
        response, "consistency_score", ["reason", "reasoning"],
        [r"consistency[_\s]*score\s*[:：]?\s*([1-5])"],
    )


def extract_instruction(response: str):
    return extract_score_and_reason(
        response, "instruction_score", ["reasoning", "reason"],
        [r"instruction[_\s]*score\s*[:：]?\s*([1-5])"],
    )


def extract_quality(response: str):
    return extract_score_and_reason(
        response, "quality_score", ["reasoning", "reason"],
        [r"quality[_\s]*score\s*[:：]?\s*([1-5])"],
    )


def _balanced_json_block(text: str) -> Optional[str]:
    depth, start = 0, None
    for i, c in enumerate(text):
        if c == "{":
            if start is None:
                start = i
            depth += 1
        elif c == "}" and depth:
            depth -= 1
            if depth == 0:
                return text[start : i + 1]
    return None


def extract_dual_scores(response: str) -> dict:
    """instruction + knowledge scores from one dual-evaluation response
    (metrics_knowledge.py:221-262): whole-response JSON, then the first
    balanced JSON block, then per-field regexes."""
    data = None
    try:
        data = json.loads(response)
    except Exception:
        block = _balanced_json_block(response)
        if block:
            try:
                data = json.loads(block)
            except Exception:
                data = None
    if data:
        return {
            "instruction_score": (
                int(data["instruction_score"])
                if data.get("instruction_score") is not None else None
            ),
            "knowledge_score": (
                int(data["knowledge_score"])
                if data.get("knowledge_score") is not None else None
            ),
            "instruction_reasoning": data.get("instruction_reasoning"),
            "knowledge_reasoning": data.get("knowledge_reasoning"),
        }
    out = {"instruction_score": None, "knowledge_score": None,
           "instruction_reasoning": None, "knowledge_reasoning": None}
    m = re.search(r'"?instruction[_\s]*score"?\s*:\s*([1-5])', response,
                  re.IGNORECASE)
    if m:
        out["instruction_score"] = int(m.group(1))
    m = re.search(r'"?knowledge[_\s]*score"?\s*:\s*([1-5])', response,
                  re.IGNORECASE)
    if m:
        out["knowledge_score"] = int(m.group(1))
    return out


# --- per-sample evaluation through a pluggable judge ------------------------


def evaluate_sample(
    judge: Callable[[str, List[str]], str],
    category: str,
    instruction: str,
    explanation: str,
    orig_image: str,
    edit_image: str,
    prompts: Optional[Dict[str, str]] = None,
    gt_image: Optional[str] = None,
) -> dict:
    """Run the category's judge calls for one edited image and return the
    score dict, routing to the category's canonical prompt exactly like
    the reference's five metric workers: multi-element_composition uses
    the *_multi prompts (metrics_multi_element.py:279-301),
    viewpoint_change uses view_instruction_following with the GT view as
    a third judge image when provided (metrics_view_change.py:255-280),
    knowledge categories use the dual evaluation, everything else the
    common prompts (metrics_common.py).

    judge(prompt_text, image_paths) -> response text. Consistency and
    instruction calls see [original, edited]; quality sees [edited] only
    (metrics_common.py:316-320)."""
    p = dict(DEFAULT_PROMPTS)
    if prompts:
        p.update(prompts)
    multi = category == "multi-element_composition"
    results: dict = {}
    for m in metrics_for_category(category):
        if m == "consistency":
            key = ("consistency_multi"
                   if multi and "consistency_multi" in p else "consistency")
            resp = judge(p[key].format(instruct=instruction),
                         [orig_image, edit_image])
            score, reason = extract_consistency(resp)
            results.update(consistency_score=score,
                           consistency_reasoning=reason)
        elif m == "instruction_following":
            # the anomaly-correction category carries an expected-correction
            # explanation and uses the abnormal prompt (metrics_common.py:313
            # checks "abnormality_correction" — matching the actual category
            # name "anomaly_correction" here, which the reference's substring
            # test misses)
            if "anomaly_correction" in category or \
                    "abnormality_correction" in category:
                prompt = p["abnormal_instruction_following"].format(
                    instruct=instruction, explanation=explanation
                )
            elif category == "viewpoint_change" and \
                    "view_instruction_following" in p:
                # the view prompt judges against the ground-truth view;
                # the GT image rides as a third judge image when the
                # caller has one (the reference skips samples without it)
                prompt = p["view_instruction_following"].format(
                    instruct=instruction
                )
                imgs = [orig_image, edit_image] + (
                    [gt_image] if gt_image else []
                )
                resp = judge(prompt, imgs)
                score, reason = extract_instruction(resp)
                results.update(instruction_score=score,
                               instruction_reasoning=reason)
                continue
            elif multi and "instruction_multi" in p:
                prompt = p["instruction_multi"].format(instruct=instruction)
            else:
                prompt = p["instruction_following"].format(
                    instruct=instruction
                )
            resp = judge(prompt, [orig_image, edit_image])
            score, reason = extract_instruction(resp)
            results.update(instruction_score=score,
                           instruction_reasoning=reason)
        elif m == "dual_score":
            resp = judge(
                p["dual_score"].format(instruct=instruction,
                                       explanation=explanation),
                [orig_image, edit_image],
            )
            results.update(extract_dual_scores(resp))
        elif m == "image_quality":
            resp = judge(p["image_quality"], [edit_image])
            score, reason = extract_quality(resp)
            results.update(quality_score=score, quality_reasoning=reason)
    return results


# --- published aggregation (summarize.py:82-162) ----------------------------


def normalize_score(score):
    """1-5 judge scale -> 100-point scale."""
    return (score - 1) * 25 if score is not None else None


def summarize(per_category_samples: Dict[str, Dict[str, dict]]) -> dict:
    """KRIS results table from per-sample score dicts.

    per_category_samples: {subitem_category: {sample_id: scores}} where
    scores carry the metric keys of KRIS_BENCHMARK_METRIC. Returns
    {"summary": {...category/meta/Overall rows...}, "subitems": {...}} with
    every score normalized to the 100-point scale; sample scores that are
    None are skipped (not zero-filled), exactly like summarize.py.
    """
    type_scores: Dict[str, Dict[str, list]] = defaultdict(
        lambda: defaultdict(list))
    type_flat: Dict[str, list] = defaultdict(list)
    subitems: Dict[str, dict] = defaultdict(dict)

    for b_type, subs in KRIS_BENCHMARK_TYPE.items():
        metrics = KRIS_BENCHMARK_METRIC[b_type]
        for sub in subs:
            samples = per_category_samples.get(sub)
            if not samples:
                continue
            sub_scores = {m: [] for m in metrics}
            for sample in samples.values():
                for m in metrics:
                    if sample.get(m) is not None:
                        v = normalize_score(sample[m])
                        sub_scores[m].append(v)
                        type_scores[b_type][m].append(v)
                        type_flat[b_type].append(v)
            sub_avg = {}
            for m in SCORE_ORDER:
                if m in metrics and sub_scores[m]:
                    sub_avg[SCORE_SHORT_NAME[m]] = (
                        sum(sub_scores[m]) / len(sub_scores[m])
                    )
            if sub_avg:
                subitems[b_type][sub] = sub_avg

    summary: Dict[str, dict] = {}
    for b_type in KRIS_BENCHMARK_TYPE:
        row = {}
        for m in SCORE_ORDER:
            if m == "average_score":
                if type_flat[b_type]:
                    row["AVG"] = (
                        sum(type_flat[b_type]) / len(type_flat[b_type])
                    )
            elif m in KRIS_BENCHMARK_METRIC[b_type]:
                vals = type_scores[b_type][m]
                if vals:
                    row[SCORE_SHORT_NAME[m]] = sum(vals) / len(vals)
        if row:
            summary[b_type] = row
    for meta, children in META_CATEGORIES.items():
        vals = [v for c in children for v in type_flat[c]]
        if vals:
            summary[meta] = {"AVG": sum(vals) / len(vals)}
    all_vals = [v for t in KRIS_BENCHMARK_TYPE for v in type_flat[t]]
    if all_vals:
        summary["Overall"] = {"AVG": sum(all_vals) / len(all_vals)}
    return {"summary": summary, "subitems": dict(subitems)}


def score_results(
    annotations: Dict[str, Dict[str, dict]],
    judge: Callable[[str, List[str]], str],
    image_of: Callable[[str, str], str],
    orig_of: Callable[[str, str], str],
    *,
    categories: Optional[Iterable[str]] = None,
    prompts: Optional[Dict[str, str]] = None,
    out_path: Optional[str] = None,
    gt_of: Optional[Callable[[str, str], Optional[str]]] = None,
) -> dict:
    """End-to-end KRIS scoring: judge every (category, sample), aggregate.

    annotations: {category: {image_id: {"ins_en": ..., "explain_en": ...}}}
    (the per-category annotation.json layout); image_of/orig_of map
    (category, image_id) -> generated / original image path. Resumable per
    category via an appended jsonl when out_path is given (the reference's
    save_result_jsonl/load_processed_keys shape, metrics_common.py:32-85)."""
    per_cat: Dict[str, Dict[str, dict]] = {}
    for cat, anns in annotations.items():
        if categories is not None and cat not in categories:
            continue
        cat_out: Dict[str, dict] = {}
        done: Dict[str, dict] = {}
        path = f"{out_path}.{cat}.jsonl" if out_path else None
        if path:
            import os

            if os.path.exists(path):
                with open(path) as f:
                    for line in f:
                        rec = json.loads(line)
                        done[rec["id"]] = rec
        fout = open(path, "a") if path else None
        try:
            for i, a in anns.items():
                sid = str(i)
                if sid in done:
                    cat_out[sid] = done[sid]
                    continue
                rec = evaluate_sample(
                    judge, cat, a.get("ins_en", ""), a.get("explain_en", ""),
                    orig_of(cat, sid), image_of(cat, sid), prompts,
                    gt_image=gt_of(cat, sid) if gt_of else None,
                )
                rec["id"] = sid
                cat_out[sid] = rec
                if fout:
                    fout.write(json.dumps(rec) + "\n")
                    fout.flush()
        finally:
            if fout:
                fout.close()
        per_cat[cat] = cat_out
    return summarize(per_cat)
