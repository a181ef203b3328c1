"""VQA-family metrics (reference eval/vlm/eval/vqa/*).

Four published metrics cover the reference's 16 VQA dataset configs
(evaluate_vqa.py:26-148):

  vqa_score         — the EvalAI 10-annotator soft accuracy
                      (textvqa_eval.py:231-267; vqav2/okvqa/textvqa/vizwiz)
  anls              — Average Normalized Levenshtein Similarity
                      (docvqa/infographicsvqa; ST-VQA formulation,
                      textvqa_eval.py:286-308, no editdistance dependency)
  relaxed_accuracy  — ChartQA 5%-numeric-tolerance match
                      (evaluate_vqa.py:152-204, pix2struct metric)
  exact match       — gqa/ocrvqa/ai2d case-insensitive max-over-annotations
                      (evaluate_vqa.py:207-218)

The normalization tables (contractions, number words, articles,
punctuation policy) ARE the metric definition — they must match the
published EvalAI processor bit-for-bit or the score is a different metric.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

# ---------------------------------------------------------------------------
# EvalAI answer normalization (the published VQA accuracy preprocessing)
# ---------------------------------------------------------------------------

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

_NUMBER_WORDS = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

_ARTICLES = frozenset({"a", "an", "the"})

# NOTE: the published PERIOD_STRIP pattern `(?!<=\d)(\.)(?!\d)` contains a
# typo'd lookbehind (`?!<=` parses as "not followed by '<='", which always
# holds) — so in practice it strips every '.' not followed by a digit.
# Matching the metric means matching that behavior.
_PERIOD_STRIP = re.compile(r"(\.)(?!\d)")
_DIGIT_COMMA = re.compile(r"(?<=\d)(\,)+(?=\d)")
_PUNCT = ";/[]\"{}()=+\\_-><@`,?!"


def _strip_punctuation(text: str) -> str:
    out = text
    has_digit_comma = _DIGIT_COMMA.search(text) is not None
    for p in _PUNCT:
        # the EvalAI rule: drop the char when it touches a space boundary
        # (or the string holds a digit-grouping comma), else space it out
        if (p + " " in text) or (" " + p in text) or has_digit_comma:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_STRIP.sub("", out)


def normalize_answer(answer: str) -> str:
    """The EvalAI answer processor (textvqa_eval.py:17-228), end to end:
    lowercase -> strip ','/'?' -> "'s" spacing -> whitespace fold ->
    punctuation policy -> number words -> drop articles -> contractions."""
    a = answer.lower().replace(",", "").replace("?", "")
    a = a.replace("'s", " 's").strip()
    a = a.replace("\n", " ").replace("\t", " ").strip()
    a = _strip_punctuation(a)
    words = []
    for w in a.lower().split():
        w = _NUMBER_WORDS.get(w, w)
        if w not in _ARTICLES:
            words.append(_CONTRACTIONS.get(w, w))
    return " ".join(words)


# ---------------------------------------------------------------------------
# vqa_score — 10-annotator soft accuracy
# ---------------------------------------------------------------------------


def soft_answer_scores(gt_answers: Sequence[str]) -> Dict[str, float]:
    """Leave-one-out consensus score for every distinct normalized answer:
    acc(ans) = mean over annotators i of min(1, |{j != i : a_j == ans}| / 3)
    (textvqa_eval.py:235-256)."""
    norm = [normalize_answer(a) for a in gt_answers]
    n = len(norm)
    counts: Dict[str, int] = {}
    for a in norm:
        counts[a] = counts.get(a, 0) + 1
    scores = {}
    for ans, c in counts.items():
        # annotator i agreeing with `ans` sees c-1 other matches, a
        # disagreeing one sees c — closed form of the published loop
        agree = min(1.0, (c - 1) / 3.0)
        disagree = min(1.0, c / 3.0)
        scores[ans] = (c * agree + (n - c) * disagree) / n
    return scores


def vqa_accuracy(results: List[dict]) -> float:
    """Mean soft score; rows carry prediction + gt_answers (the 10
    annotator strings)."""
    if not results:
        return 0.0
    if not all("gt_answers" in r for r in results):
        raise ValueError(
            "vqa_score rows need gt_answers (the 10 annotator strings) — "
            "prep with `data_prep.py vqa --annotation <official json>`"
        )
    total = 0.0
    for r in results:
        pred = normalize_answer(r.get("prediction") or "")
        total += soft_answer_scores(r["gt_answers"]).get(pred, 0.0)
    return total / len(results)


# ---------------------------------------------------------------------------
# ANLS — docvqa / infographicsvqa
# ---------------------------------------------------------------------------


def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls_similarity(pred: str, gt: str, threshold: float = 0.5) -> float:
    """1 - NL distance, zeroed below the 0.5 threshold (the ST-VQA/DocVQA
    rule, textvqa_eval.py:292-297)."""
    s1, s2 = pred.lower().strip(), gt.lower().strip()
    if not s1 and not s2:
        return 1.0
    denom = max(len(s1), len(s2))
    if denom == 0:
        return 0.0
    sim = 1.0 - _levenshtein(s1, s2) / denom
    return sim if sim >= threshold else 0.0


def anls_score(results: List[dict]) -> float:
    """Mean over rows of the best ANLS against any annotation."""
    if not results:
        return 0.0
    total = 0.0
    for r in results:
        gts = r.get("gt_answers") or _as_list(r.get("annotation"))
        pred = r.get("prediction") or ""
        total += max((anls_similarity(pred, g) for g in gts), default=0.0)
    return total / len(results)


# ---------------------------------------------------------------------------
# relaxed accuracy (ChartQA) + exact match (gqa/ocrvqa/ai2d)
# ---------------------------------------------------------------------------


def _to_float(text: str) -> Optional[float]:
    try:
        if text.endswith("%"):
            return float(text.rstrip("%")) / 100.0
        return float(text)
    except ValueError:
        return None


def relaxed_match(target: str, prediction: str, tol: float = 0.05) -> bool:
    """Numeric answers match within 5% relative error; everything else
    needs a case-insensitive exact match (evaluate_vqa.py:152-191)."""
    p, t = _to_float(prediction), _to_float(target)
    if p is not None and t:  # reference guards target truthiness (0 falls
        return abs(p - t) / abs(t) <= tol  # through to string compare)
    return prediction.lower() == target.lower()


def _as_list(x) -> List[str]:
    if x is None:
        return []
    return [x] if isinstance(x, str) else list(x)


def relaxed_accuracy(results: List[dict]) -> float:
    if not results:
        return 0.0
    total = 0.0
    for r in results:
        gts = r.get("gt_answers") or _as_list(r.get("annotation"))
        pred = (r.get("prediction") or "").strip()
        total += max((relaxed_match(pred, g) for g in gts), default=False)
    return total / len(results)


def exact_match_accuracy(results: List[dict]) -> float:
    """Case-insensitive match against any annotation
    (evaluate_vqa.py:207-218)."""
    if not results:
        return 0.0
    total = 0.0
    for r in results:
        gts = r.get("gt_answers") or _as_list(r.get("annotation"))
        pred = (r.get("prediction") or "").strip().lower()
        total += any(pred == g.strip().lower() for g in gts)
    return total / len(results)


# ---------------------------------------------------------------------------
# short-answer cleanup (the reference's generation post_process)
# ---------------------------------------------------------------------------


def short_answer(response: str) -> str:
    """First clause, leading copulas/articles stripped, ' of' tail cut
    (evaluate_vqa.py:300-316) — applied to free-form generations before
    scoring short-answer suites."""
    r = response.strip().split(".")[0].split(",")[0].split("!")[0].lower()
    for lead in ("is ", "are ", "a ", "an ", "the "):
        if lead in r:
            r = r.split(lead)[1]
    if " of" in r:
        r = r.split(" of")[0]
    return r.strip()
