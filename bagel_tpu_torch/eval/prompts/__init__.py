"""Canonical judge-prompt loader (vendored benchmark data — see README.md).

`load(bench, name)` returns the byte-exact reference prompt text or None
when the file is missing (callers then fall back to their
rubric-equivalent paraphrases). Composition helpers mirror exactly how
the reference assembles each judge message:

- WISE: system text + user f-string with Prompt/Explanation slots
  (wise/gpt_eval_mp.py:71-155).
- GEdit VIEScore TIE: SC = "\\n".join([context, two_image_edit_rule,
  tie_rule_SC]) with <instruction> substituted; PQ = "\\n".join([context,
  rule_PQ]) (viescore/__init__.py:26-54).
- KRIS: prompts keyed by the scorer's metric names; `quality` is sent
  UNformatted (the reference never .format()s it, so its literal {{ }}
  braces reach the judge doubled — byte parity preserves the quirk).
- RISE: prompts keyed by the plan_judges prompt_keys (rise/gpt_eval.py
  :146-200), formatted with {instruct}/{reference} by the scorer.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, Optional

_DIR = os.path.dirname(os.path.abspath(__file__))


@lru_cache(maxsize=None)
def load(bench: str, name: str) -> Optional[str]:
    path = os.path.join(_DIR, bench, f"{name}.txt")
    try:
        with open(path, encoding="utf-8", newline="") as f:
            return f.read()
    except OSError:
        return None


def wise_system() -> Optional[str]:
    return load("wise", "system")


def wise_user(prompt: str, explanation: str = "") -> Optional[str]:
    tpl = load("wise", "user")
    return None if tpl is None else tpl.format(prompt=prompt,
                                               explanation=explanation)


def vie_sc_tie(instruction: str) -> Optional[str]:
    parts = [load("gedit", "context_no_delimit"),
             load("gedit", "prompts_0shot_two_image_edit_rule"),
             load("gedit", "prompts_0shot_tie_rule_SC")]
    if any(p is None for p in parts):
        return None
    return "\n".join(parts).replace("<instruction>", instruction)


def vie_pq() -> Optional[str]:
    parts = [load("gedit", "context_no_delimit"),
             load("gedit", "prompts_0shot_rule_PQ")]
    if any(p is None for p in parts):
        return None
    return "\n".join(parts)


def vie_sc_t2i(prompt: str) -> Optional[str]:
    parts = [load("gedit", "context_no_delimit"),
             load("gedit", "prompts_0shot_one_image_gen_rule"),
             load("gedit", "prompts_0shot_t2i_rule_SC")]
    if any(p is None for p in parts):
        return None
    return "\n".join(parts).replace("<prompt>", prompt)


# scorer metric key -> vendored kris file
_KRIS_KEYS = {
    "consistency": "consist",
    "instruction_following": "instruction_following",
    "abnormal_instruction_following": "abnormal_instruction_following",
    "image_quality": "quality",
    "dual_score": "dual_evaluation",
    "view_instruction_following": "view_instruction_following",
    "consistency_multi": "consist_multi",
    "instruction_multi": "instruction_multi",
    "consistency_temporal": "consist_temporal",
    "instruction_temporal": "instruction_temporal",
}


def kris_defaults() -> Dict[str, str]:
    """Canonical KRIS prompts under the scorer's metric keys (only the
    files that exist — callers overlay onto their paraphrase defaults)."""
    out = {}
    for key, name in _KRIS_KEYS.items():
        text = load("kris", name)
        if text is not None:
            out[key] = text
    return out


def rise_defaults() -> Dict[str, str]:
    """Canonical RISE prompts keyed by plan_judges prompt_keys."""
    out = {}
    bench_dir = os.path.join(_DIR, "rise")
    try:
        names = sorted(os.listdir(bench_dir))
    except OSError:
        return out
    for fn in names:
        if fn.endswith(".txt"):
            out[fn[:-4]] = load("rise", fn[:-4])
    return out
