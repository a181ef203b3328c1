"""GPT-judge scoring pipelines: WISE WiScore and VIEScore/GEdit SC-PQ.

The judge itself is a pluggable callable `judge(prompt_text, image_paths)
-> str` (the reference posts to GPT-4o / GPT-4.1 — eval/gen/wise/
gpt_eval_mp.py, eval/gen/gedit/viescore/*); everything around it — retry,
resume, score extraction, aggregation — is reimplemented here and
unit-testable with a canned judge.

Published aggregations:
- WiScore = 0.7*consistency + 0.2*realism + 0.1*aesthetic_quality, category
  averages normalized by 2*N (wise/cal_score.py:10-45); sentinel 9.9 marks
  judge failures and poisons the category.
- VIEScore overall = sqrt(min(SC) * min(PQ)) per sample
  (gedit/viescore/__init__.py:77-84); GEdit group table averages SC / PQ /
  sqrt(SC*PQ) per edit group, plus the intersection subset
  (gedit/calculate_statistics.py:30-110).
"""

from __future__ import annotations

import json
import math
import os
import re
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence

JUDGE_FAILURE = 9.9  # reference sentinel for unparseable / failed judgments

_WISE_PATTERN = re.compile(
    r"\*{0,2}(Consistency|Realism|Aesthetic Quality)\*{0,2}\s*[:：]?\s*(\d)",
    re.IGNORECASE,
)


def build_wise_prompt(prompt: str, explanation: str = "") -> str:
    """WISE judge instruction. Canonical-first: returns the byte-exact
    reference user prompt (gpt_eval_mp.py:85-144, vendored under
    eval/prompts/wise/) with the Prompt/Explanation slots filled; the
    system text is available via eval.prompts.wise_system() for judges
    that carry a system message. Falls back to the rubric-equivalent
    paraphrase below only when the vendored file is missing."""
    from bagel_tpu_torch.eval.prompts import wise_user

    canonical = wise_user(prompt, explanation)
    if canonical is not None:
        return canonical
    return f"""You are a strict quality auditor for text-to-image generation.
Evaluate the attached image against the PROMPT (and its EXPLANATION) on
three 0-2 rubrics. Be ruthless: a 2 is reserved for flawless results.

Consistency (0-2): how accurately and completely the image realizes the
PROMPT. 0 = misses or contradicts key elements; 1 = partial/inaccurate
coverage; 2 = every element and nuance is perfectly represented.
Realism (0-2): 0 = physically implausible, clearly artificial; 1 = minor
unrealistic flaws; 2 = indistinguishable from a real photograph.
Aesthetic Quality (0-2): 0 = poor composition, no artistic merit; 1 =
basic appeal without distinction; 2 = exceptional, masterpiece-level.

Return ONLY three lines, no other text:
Consistency: <0-2>
Realism: <0-2>
Aesthetic Quality: <0-2>

PROMPT: "{prompt}"
EXPLANATION: "{explanation}"
"""


# -- VIEScore (GEdit TIE task) ------------------------------------------------

_VIE_CONTEXT = (
    "You are a professional digital artist evaluating AI-generated "
    "image(s) according to the rules below. Respond with a JSON object "
    'of the form {"score": [..], "reasoning": ".."}. Scores are integers '
    "0-10."
)


def build_vie_sc_tie_prompt(instruction: str) -> str:
    """Semantic-consistency judge prompt for an edit pair (VIEScore tie
    task): canonical-first — the byte-exact "\\n".join([context,
    two_image_edit_rule, tie_rule_SC]) composition of viescore/
    __init__.py:31 with <instruction> substituted (vendored under
    eval/prompts/gedit/); paraphrase fallback below. Two images
    (original, edited), two 0-10 scores — editing success and (lack of)
    overediting."""
    from bagel_tpu_torch.eval.prompts import vie_sc_tie

    canonical = vie_sc_tie(instruction)
    if canonical is not None:
        return canonical
    return f"""{_VIE_CONTEXT}

RULES: Two images are provided — the first is the original AI-generated
image, the second an edited version of it. Evaluate how successfully the
editing instruction was executed in the second image (they may look
identical if the edit failed).

Give two scores on a 0-10 scale:
- score1 (editing success): 0 = the edited image does not follow the
  instruction at all; 10 = it follows the instruction perfectly.
- score2 (overediting): 0 = the edited image is completely different from
  the original; 10 = a minimal yet effective edit of the original.

Output score = [score1, score2].

Editing instruction: {instruction}
"""


def build_vie_pq_prompt() -> str:
    """Perceptual-quality judge prompt: canonical-first (context +
    rule_PQ, viescore/__init__.py:32); paraphrase fallback. Edited image
    only, two 0-10 scores — naturalness and freedom from artifacts."""
    from bagel_tpu_torch.eval.prompts import vie_pq

    canonical = vie_pq()
    if canonical is not None:
        return canonical
    return f"""{_VIE_CONTEXT}

RULES: The image is AI-generated. Evaluate how successfully it was
generated, with two scores on a 0-10 scale:
- score1 (naturalness): 0 = unnatural scene (wrong distances, shadows,
  lighting); 10 = the image looks natural.
- score2 (artifacts): 0 = large portions of distortion, watermarks,
  scratches, blurred faces or unusual body parts; 10 = no artifacts.

Output score = [naturalness, artifacts].
"""


def parse_vie_scores(text: str) -> List[float]:
    """Extract the VIEScore score list from a judge reply: JSON object with
    a 'score' field first, then a bare list, then a bare 0-10 integer
    (utils.py mllm_output_to_dict fallback chain). Raises ValueError when
    nothing parses (run_judge retries, then sentinels)."""
    s, e = text.find("{"), text.rfind("}") + 1
    if s != -1 and e:
        try:
            obj = json.loads(text[s:e])
            scores = obj["score"]
            return [float(x) for x in (scores if isinstance(scores, list)
                                       else [scores])]
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            pass
    s, e = text.find("["), text.rfind("]") + 1
    if s != -1 and e:
        try:
            return [float(x) for x in json.loads(text[s:e])]
        except (json.JSONDecodeError, TypeError, ValueError):
            pass
    stripped = text.strip()
    if stripped.isdigit() and 0 <= int(stripped) <= 10:
        return [float(stripped)]
    raise ValueError(f"unparseable VIE judge output: {text[:80]!r}")


def vie_evaluate_tie(judge, source_path: str, edited_path: str,
                     instruction: str):
    """One GEdit sample through the two-call VIEScore protocol
    (viescore/__init__.py:37-85): SC over [source, edited], PQ over
    [edited]; per-sample scores are the MIN over each list."""
    sc = parse_vie_scores(judge(build_vie_sc_tie_prompt(instruction),
                                [source_path, edited_path]))
    pq = parse_vie_scores(judge(build_vie_pq_prompt(), [edited_path]))
    return min(sc), min(pq)


def extract_wise_scores(evaluation_text: str) -> Dict[str, float]:
    """Parse the three 0-2 scores; missing ones keep the failure sentinel
    (gpt_eval_mp.py:44-59)."""
    scores = {
        "consistency": JUDGE_FAILURE,
        "realism": JUDGE_FAILURE,
        "aesthetic_quality": JUDGE_FAILURE,
    }
    for name, value in _WISE_PATTERN.findall(evaluation_text):
        key = name.strip().lower().replace(" ", "_")
        if key in scores:
            scores[key] = float(value)
    return scores


def wiscore(consistency: float, realism: float, aesthetic_quality: float) -> float:
    return 0.7 * consistency + 0.2 * realism + 0.1 * aesthetic_quality


def wise_summarize(
    records: Iterable[dict],
    category_of: Optional[Callable[[dict], str]] = None,
) -> dict:
    """Category-average WiScores normalized by the 2.0 max (cal_score.py).

    records: {'consistency', 'realism', 'aesthetic_quality', ...}. A
    sentinel 9.9 in any record poisons its category (reported as None,
    matching the reference's skip)."""
    cats: Dict[str, List[float]] = defaultdict(list)
    poisoned = set()
    for r in records:
        cat = category_of(r) if category_of else r.get("category", "all")
        vals = (r["consistency"], r["realism"], r["aesthetic_quality"])
        if JUDGE_FAILURE in vals:
            poisoned.add(cat)
        cats[cat].append(wiscore(*vals))
    averages = {
        c: (None if c in poisoned else sum(v) / (len(v) * 2.0))
        for c, v in cats.items()
    }
    valid = [v for v in averages.values() if v is not None]
    return {
        "categories": averages,
        "overall": sum(valid) / len(valid) if valid else None,
    }


def viescore_overall(sc_scores: Sequence[float], pq_scores: Sequence[float]) -> float:
    """Per-sample overall: sqrt(min(SC) * min(PQ))."""
    return math.sqrt(min(sc_scores) * min(pq_scores))


def gedit_summarize(rows: Iterable[dict]) -> dict:
    """GEdit group table (calculate_statistics.py:30-110).

    rows: {'group', 'semantics_score', 'quality_score'
    [, 'intersection_exist']}. Per-group averages of SC, PQ and
    sqrt(SC*PQ); model row = unweighted mean over groups; the intersection
    subset gets the same treatment."""
    def table(selected: List[dict]) -> dict:
        groups: Dict[str, dict] = {}
        by_group: Dict[str, List[dict]] = defaultdict(list)
        for r in selected:
            by_group[r["group"]].append(r)
        for g, rs in by_group.items():
            sc = [r["semantics_score"] for r in rs]
            pq = [r["quality_score"] for r in rs]
            ov = [math.sqrt(s * q) for s, q in zip(sc, pq)]
            groups[g] = {
                "SC": sum(sc) / len(sc),
                "PQ": sum(pq) / len(pq),
                "O": sum(ov) / len(ov),
                "n": len(rs),
            }
        if groups:
            avg = {
                k: sum(groups[g][k] for g in groups) / len(groups)
                for k in ("SC", "PQ", "O")
            }
        else:
            avg = {"SC": 0.0, "PQ": 0.0, "O": 0.0}
        return {"groups": groups, "avg": avg}

    rows = list(rows)
    out = {"full": table(rows)}
    inter = [r for r in rows if r.get("intersection_exist")]
    if inter:
        out["intersection"] = table(inter)
    return out


def run_judge(
    items: Sequence[dict],
    build_prompt: Callable[[dict], str],
    judge: Callable[[str, List[str]], str],
    extract: Callable[[str], dict],
    *,
    out_path: Optional[str] = None,
    max_retries: int = 2,
    image_paths_of: Optional[Callable[[dict], List[str]]] = None,
) -> List[dict]:
    """Generic judge worker: resumable (skips ids already in out_path),
    retried, appending one JSON line per item — the harness shape shared by
    WISE / KRIS / RISE / GEdit / ImgEdit judge scripts."""
    done = set()
    results: List[dict] = []
    if out_path and os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                rec = json.loads(line)
                done.add(rec["id"])
                results.append(rec)
    fout = open(out_path, "a") if out_path else None
    try:
        for item in items:
            if item["id"] in done:
                continue
            images = image_paths_of(item) if image_paths_of else item.get("images", [])
            record = None
            for _ in range(max_retries + 1):
                try:
                    raw = judge(build_prompt(item), images)
                    record = {"id": item["id"], **item.get("meta", {}), **extract(raw)}
                    break
                except Exception:
                    continue
            if record is None:
                # shape the failure like a success with sentinel scores
                # (extract("") yields all-JUDGE_FAILURE fields) so the
                # summarizers aggregate it — the sentinel poisons its
                # category per the reference — instead of KeyError-ing
                try:
                    sentinel = extract("")
                except Exception:
                    sentinel = {}
                record = {"id": item["id"], **item.get("meta", {}),
                          **sentinel, "judge_failed": True}
            results.append(record)
            if fout:
                fout.write(json.dumps(record) + "\n")
                fout.flush()
    finally:
        if fout:
            fout.close()
    return results
