"""VLM evaluation runner + scorers.

The reference's eval/vlm family (InternVL-style per-benchmark torchrun
scripts with InferenceSampler rank sharding calling Bagel.chat,
eval/vlm/eval/*) collapses into one generic runner: a jsonl of
{image, question, answer?, category?, index?} rows is sharded across
processes, answered via the engine's understanding mode, and merged to a
results jsonl. Pure-python scorers cover the non-LLM-judged benchmarks:
yes/no suites (MME accuracy/accuracy+, POPE precision/recall/F1) and
multiple-choice extraction (MMBench/MMMU style). GPT-judged suites plug a
callable judge into score_with_judge.

  python -m bagel_tpu_torch.eval.vlm_runner --checkpoint ... --data qa.jsonl \
      --image_root imgs/ --out results.jsonl [--score yesno|choice] \
      [--device cpu]

Port of bagel_tpu/eval/vlm_runner.py. The engine runs on CUDA unless
`--device` names another device. Rows are sharded over the processes of
the torch.distributed group: under torchrun (WORLD_SIZE > 1) `main` starts
it (nccl on CUDA, gloo on the CPU), each rank writes `<out>.rank<r>`, and
rank 0 merges them, sorted by index, into `<out>`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Callable, Dict, List, Optional


def load_rows(path: str) -> List[dict]:
    rows = []
    with open(path) as f:
        for i, line in enumerate(f):
            if line.strip():
                row = json.loads(line)
                row.setdefault("index", i)
                rows.append(row)
    return rows


def shard(rows: List[dict], rank: int, world: int) -> List[dict]:
    return rows[rank::world]


def run_eval(
    engine,
    vit_transform,
    rows: List[dict],
    image_root: str = "",
    max_length: int = 256,
    think: bool = False,
    batch_size: int = 1,
) -> List[dict]:
    from PIL import Image

    from bagel_tpu_torch.data.transforms import pil_img2rgb

    def load(row):
        if not row.get("image"):
            return None
        img = pil_img2rgb(Image.open(os.path.join(image_root, row["image"])))
        return vit_transform(img)

    results = []
    if batch_size > 1 and not think:
        # batched decode (chat_batch): B sessions per device pass
        for i in range(0, len(rows), batch_size):
            chunk = rows[i : i + batch_size]
            answers = engine.chat_batch(
                [load(r) for r in chunk],
                [r.get("question") or r.get("text") for r in chunk],
                max_length=max_length,
            )
            results.extend({**r, "prediction": a} for r, a in zip(chunk, answers))
        return results

    for row in rows:
        out = engine(
            image=load(row), text=row.get("question") or row.get("text"),
            understanding_output=True, think=think,
            max_think_token_n=max_length,
        )
        results.append({**row, "prediction": out["text"]})
    return results


# ---------------------------------------------------------------------------
# Scorers
# ---------------------------------------------------------------------------


def _norm_yesno(text: str) -> Optional[str]:
    t = text.strip().lower()
    if t.startswith("yes") or " yes" in t[:16]:
        return "yes"
    if t.startswith("no") or " no" in t[:16]:
        return "no"
    return None


def score_yesno(results: List[dict]) -> Dict[str, float]:
    """MME/POPE-family: accuracy, accuracy+ (both questions of an image
    correct — eval/vlm/eval/mme/calculation.py semantics), precision/recall/
    F1 on 'yes'."""
    tp = fp = tn = fn = unk = 0
    by_image: Dict[str, List[bool]] = {}
    for r in results:
        gt = str(r["answer"]).strip().lower()
        pred = _norm_yesno(r["prediction"] or "")
        correct = pred == gt
        by_image.setdefault(str(r.get("image", r["index"])), []).append(correct)
        if pred is None:
            unk += 1
            continue
        if pred == "yes" and gt == "yes":
            tp += 1
        elif pred == "yes" and gt == "no":
            fp += 1
        elif pred == "no" and gt == "no":
            tn += 1
        else:
            fn += 1
    n = len(results)
    acc = (tp + tn) / max(n, 1)
    acc_plus = sum(all(v) for v in by_image.values()) / max(len(by_image), 1)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-8)
    return dict(accuracy=acc, accuracy_plus=acc_plus, precision=precision,
                recall=recall, f1=f1, unknown_rate=unk / max(n, 1),
                mme_score=100 * (acc + acc_plus))


def extract_choice(text: str, choices: str = "ABCD") -> Optional[str]:
    """Multiple-choice letter extraction (MMBench/MMMU answer parsing)."""
    if not text:
        return None
    t = text.strip()
    m = re.match(rf"^[\(\[]?([{choices}])[\)\].:,\s]", t + " ")
    if m:
        return m.group(1)
    m = re.search(rf"answer is[:\s]+[\(\[]?([{choices}])", t, re.I)
    if m:
        return m.group(1).upper()
    m = re.search(rf"\b([{choices}])\b", t)
    return m.group(1) if m else None


def score_choice(results: List[dict]) -> Dict[str, float]:
    correct = total = 0
    per_cat: Dict[str, List[bool]] = {}
    for r in results:
        pred = extract_choice(r["prediction"] or "")
        ok = pred is not None and pred == str(r["answer"]).strip().upper()
        per_cat.setdefault(r.get("category", "all"), []).append(ok)
        correct += ok
        total += 1
    out = {"accuracy": correct / max(total, 1)}
    for cat, oks in per_cat.items():
        out[f"acc/{cat}"] = sum(oks) / len(oks)
    return out


def score_exact(results: List[dict]) -> Dict[str, float]:
    """VQA-style relaxed exact match."""
    ok = 0
    for r in results:
        pred = (r["prediction"] or "").strip().lower().rstrip(".")
        ans = str(r["answer"]).strip().lower()
        ok += pred == ans or ans in pred
    return {"accuracy": ok / max(len(results), 1)}


_NUM_RE = re.compile(r"-?\d+\.?\d*")


def extract_number(text: str) -> Optional[float]:
    """Last numeric value in the answer (MathVista-style extraction —
    eval/vlm/eval/mathvista uses a GPT extractor; this is the offline
    fallback)."""
    if not text:
        return None
    m = _NUM_RE.findall(text.replace(",", ""))
    return float(m[-1]) if m else None


def score_numeric(results: List[dict], rel_tol: float = 1e-3) -> Dict[str, float]:
    ok = total = 0
    for r in results:
        pred = extract_number(r["prediction"] or "")
        try:
            ans = float(str(r["answer"]).replace(",", ""))
        except ValueError:
            continue
        total += 1
        if pred is not None and abs(pred - ans) <= rel_tol * max(1.0, abs(ans)):
            ok += 1
    return {"accuracy": ok / max(total, 1), "scored": total}


def score_with_judge(results: List[dict], judge: Callable[[dict], float]):
    """GPT-judged suites (MMVet / MathVista / WISE-style): `judge` maps one
    result row to a score in [0, 1]."""
    scores = [judge(r) for r in results]
    return {"judge_score": sum(scores) / max(len(scores), 1)}


def score_mme(results: List[dict]) -> Dict:
    """Published MME tables: rows carry category=task, image, answer. Rows
    pair up per (task, image) — exactly two questions per image."""
    from collections import defaultdict

    from bagel_tpu_torch.eval.scorers.mme import mme_score

    tasks = defaultdict(list)
    for r in sorted(results, key=lambda r: (str(r.get("category", "all")),
                                            str(r.get("image", r["index"])),
                                            r["index"])):
        tasks[r.get("category", "all")].append(
            (str(r.get("image", r["index"])), str(r["answer"]).lower(),
             r["prediction"] or "")
        )
    return mme_score(tasks)


def score_mmmu(results: List[dict]) -> Dict:
    """Published MMMU parsing: multi-choice rows carry 'options'
    ({letter: text}); open rows are parsed for key sub-answers."""
    from bagel_tpu_torch.eval.scorers.mmmu import (
        mmmu_accuracy,
        parse_multi_choice_response,
        parse_open_response,
    )

    samples = []
    for r in results:
        opts = r.get("options")
        if opts:
            qtype = "multiple-choice"
            pred = parse_multi_choice_response(
                r["prediction"] or "", list(opts.keys()), opts
            )
        else:
            qtype = "open"
            pred = parse_open_response(r["prediction"] or "")
        samples.append({
            "id": r["index"], "subject": r.get("category", "all"),
            "question_type": qtype, "answer": r["answer"],
            "parsed_pred": pred,
        })
    return mmmu_accuracy(samples)


def score_mmbench(results: List[dict]) -> Dict:
    """Published MMBench letter extraction + circular consistency."""
    from bagel_tpu_torch.eval.scorers.mmbench import (
        extract_option_letter,
        mmbench_accuracy,
        mmbench_circular_accuracy,
    )

    rows = [{
        "index": r["index"],
        "prediction": extract_option_letter(r["prediction"] or "",
                                            r.get("options", {})),
        "answer": r["answer"],
        "category": r.get("category", "all"),
    } for r in results]
    return {
        "plain": mmbench_accuracy(rows),
        "circular": mmbench_circular_accuracy(rows),
    }


def score_pope(results: List[dict]) -> Dict:
    from bagel_tpu_torch.eval.scorers.pope import pope_score

    return pope_score([
        (str(r["answer"]).strip().lower(), r["prediction"] or "")
        for r in results
    ])


def score_mmmu_cot(results: List[dict], judge=None) -> Dict:
    """MMMU CoT run: strip <think> blocks / take the 'Final Answer:' tail,
    then the standard parsers, aggregated into the published per-domain
    table (evaluate_mmmu_cot.py + main_eval_only.py)."""
    from bagel_tpu_torch.eval.scorers.mmmu import (
        extract_cot_answer,
        mmmu_domain_table,
        parse_multi_choice_response,
        parse_open_response,
        subject_of_data_id,
    )

    samples = []
    for r in results:
        text = extract_cot_answer(r["prediction"] or "")
        opts = r.get("options")
        if opts:
            qtype = "multiple-choice"
            pred = parse_multi_choice_response(text, list(opts.keys()), opts)
        else:
            qtype = "open"
            pred = parse_open_response(text)
        subject = r.get("category") or subject_of_data_id(str(r["index"]))
        samples.append({
            "id": r["index"], "subject": subject, "question_type": qtype,
            "answer": r["answer"], "parsed_pred": pred,
        })
    return mmmu_domain_table(samples)


def score_mathvista(results: List[dict], judge=None) -> Dict:
    """Full MathVista pipeline: the extraction cascade (type shortcuts ->
    quick regex -> optional GPT judge, extract_answer.py) feeding
    normalize + the published accuracy tables (calculate_score.py)."""
    from bagel_tpu_torch.eval.scorers.mathvista import (
        extract_answer_with_judge,
        mathvista_score,
    )

    rows = []
    for r in results:
        problem = {
            "question_type": r.get("question_type", ""),
            "answer_type": r.get("answer_type", ""),
            "choices": r.get("choices") or [],
            "query": r.get("question", ""),
        }
        extraction = extract_answer_with_judge(
            r["prediction"] or "", problem, judge=judge,
            quick_extract=judge is None,
        )
        rows.append({**r, "extraction": extraction})
    return mathvista_score(rows)


def score_vqa(results: List[dict]) -> Dict:
    """Published EvalAI soft accuracy (vqav2/okvqa/textvqa/vizwiz — rows
    carry gt_answers, the 10 annotator strings)."""
    from bagel_tpu_torch.eval.scorers.vqa import vqa_accuracy

    return {"vqa_score": vqa_accuracy(results)}


def score_anls(results: List[dict]) -> Dict:
    """DocVQA/InfographicsVQA ANLS."""
    from bagel_tpu_torch.eval.scorers.vqa import anls_score

    return {"anls": anls_score(results)}


def score_relaxed(results: List[dict]) -> Dict:
    """ChartQA relaxed accuracy (5% numeric tolerance)."""
    from bagel_tpu_torch.eval.scorers.vqa import relaxed_accuracy

    return {"relaxed_accuracy": relaxed_accuracy(results)}


def score_vqa_exact(results: List[dict]) -> Dict:
    """gqa/ocrvqa/ai2d max-over-annotations exact match."""
    from bagel_tpu_torch.eval.scorers.vqa import exact_match_accuracy

    return {"accuracy": exact_match_accuracy(results)}


def score_mmvp(results: List[dict]) -> Dict:
    """MMVP paired accuracy (both questions of a pair must be right)."""
    from bagel_tpu_torch.eval.scorers.mmvp import mmvp_score

    return mmvp_score(results)


def score_mmvet(results: List[dict], judge=None) -> Dict:
    """MM-Vet grading protocol + capability tables; offline containment
    fallback without a judge."""
    from bagel_tpu_torch.eval.scorers.mmvet import mmvet_score

    return mmvet_score(results, judge=judge)


SCORERS = {
    "yesno": score_yesno,
    "choice": score_choice,
    "exact": score_exact,
    "numeric": score_numeric,
    "mme": score_mme,
    "mmmu": score_mmmu,
    "mmmu_cot": score_mmmu_cot,
    "mathvista": score_mathvista,
    "mmbench": score_mmbench,
    "pope": score_pope,
    "vqa": score_vqa,
    "anls": score_anls,
    "relaxed": score_relaxed,
    "vqa_exact": score_vqa_exact,
    "mmvp": score_mmvp,
    "mmvet": score_mmvet,
}
_JUDGE_SCORERS = {"mmmu_cot", "mathvista", "mmvet"}


def main(argv=None):
    p = argparse.ArgumentParser("bagel_tpu_torch vlm eval")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--mesh", type=str, default=None,
                   help="dp,fsdp,tp: not ported yet (raises)")
    p.add_argument("--device", type=str, default=None,
                   help="the engine's device (default: CUDA)")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--image_root", type=str, default="")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--score", type=str, default=None, choices=list(SCORERS))
    p.add_argument("--max_length", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=1,
                   help=">1 enables batched prefill+decode (chat_batch)")
    p.add_argument("--think", action="store_true")
    p.add_argument("--max_kv", type=int, default=8192)
    p.add_argument("--max_latent_size", type=int, default=64)
    p.add_argument("--quant", type=str, default=None,
                   choices=[None, "int8", "w8a8", "int4", "nf4"],
                   help="serve the eval model quantized (serving/app.py "
                        "--quant semantics)")
    p.add_argument("--no_fuse", action="store_true",
                   help="keep separate q/k/v and gate/up projections")
    p.add_argument("--judge", type=str, default=None,
                   help="pkg.module:function judge callable for the "
                        "GPT-extraction scorers (mathvista); offline "
                        "regex fallbacks apply without it")
    args = p.parse_args(argv)

    if args.think and args.batch_size > 1:
        p.error("--think decodes one session at a time; use --batch_size 1")

    from bagel_tpu_torch.serving.app import build_engine
    from bagel_tpu_torch.utils.device import process_rank_world, resolve_device

    # the group first: under torchrun it picks each process's card
    rank, nproc, started = process_rank_world(resolve_device(args.device))
    try:
        engine, vae_tf, vit_tf = build_engine(args)
        rows = shard(load_rows(args.data), rank, nproc)
        results = run_eval(engine, vit_tf, rows, args.image_root,
                           args.max_length, args.think, args.batch_size)
        out_path = args.out if nproc == 1 else f"{args.out}.rank{rank}"
        with open(out_path, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")

        if nproc > 1:
            # wait for every rank's file, then merge + score on process 0
            # (reference merges via all_gather_object, evaluate_mmbench.py:219-227)
            import torch.distributed as dist

            dist.barrier()
            if rank != 0:
                return
            results = []
            for r in range(nproc):
                results.extend(load_rows(f"{args.out}.rank{r}"))
            results.sort(key=lambda x: x["index"])
            with open(args.out, "w") as f:
                for r in results:
                    f.write(json.dumps(r) + "\n")
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()
    if args.score:
        if args.score in _JUDGE_SCORERS:
            judge = None
            if args.judge:
                import importlib

                mod, _, fn = args.judge.partition(":")
                judge = getattr(importlib.import_module(mod), fn)
            scores = SCORERS[args.score](results, judge=judge)
        else:
            scores = SCORERS[args.score](results)
        with open(args.out + ".scores.json", "w") as f:
            json.dump(scores, f, indent=2, default=str)
        print(json.dumps(scores, indent=2, default=str))


if __name__ == "__main__":
    main()
