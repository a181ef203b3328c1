"""Score KRIS / RISE / ImgEdit result directories with a pluggable judge.

The reference scores these benchmarks with GPT-4o workers
(eval/gen/kris/metrics_*.py, rise/gpt_eval.py, imgedit/basic_bench.py +
step1/step2). The metric machinery — prompt routing, extraction,
aggregation — lives in bagel_tpu_torch/eval/scorers/{kris,rise,imgedit}.py; the
judge itself is external (API access) and plugs in as

  --judge pkg.module:function    callable (prompt_text, [image_paths]) -> str

`bagel_tpu_torch.eval.http_judge:judge` posts each call to the endpoint
named by BAGEL_JUDGE_URL.

Usage:
  python -m bagel_tpu_torch.eval.judge_scorer kris \
      --bench_dir KRIS_Bench --results_dir results/kris/bagel \
      --judge bagel_tpu_torch.eval.http_judge:judge --out results/kris/scores
  python -m bagel_tpu_torch.eval.judge_scorer rise \
      --data data.json --results_dir results/rise --input_dir data \
      --judge bagel_tpu_torch.eval.http_judge:judge   # canonical prompts by default
  python -m bagel_tpu_torch.eval.judge_scorer imgedit \
      --edit_json basic_edit.json --results_dir results/imgedit \
      --origin_root imgs --prompts prompts.json --judge bagel_tpu_torch.eval.http_judge:judge
"""

from __future__ import annotations

import argparse
import importlib
import json
import os


def load_callable(spec: str):
    mod, _, fn = spec.partition(":")
    return getattr(importlib.import_module(mod), fn)


def score_kris(args, judge):
    from bagel_tpu_torch.eval.scorers.kris import KRIS_BENCHMARK_TYPE, score_results

    cats = args.categories or [
        c for subs in KRIS_BENCHMARK_TYPE.values() for c in subs
    ]
    annotations = {}
    for cat in cats:
        ann_file = os.path.join(args.bench_dir, cat, "annotation.json")
        if not os.path.exists(ann_file):
            print(f"# skip {cat}: no {ann_file}")
            continue
        with open(ann_file) as f:
            annotations[cat] = json.load(f)

    def image_of(cat, image_id):
        return os.path.join(args.results_dir, cat, f"{image_id}.png")

    def orig_of(cat, image_id):
        entry = annotations[cat][image_id]
        return os.path.join(args.bench_dir, cat, entry["ori_img"])

    def gt_of(cat, image_id):
        # viewpoint_change judges against the ground-truth view
        # (metrics_view_change.py:233-250)
        rel = annotations[cat][image_id].get("gt_img")
        return os.path.join(args.bench_dir, cat, rel) if rel else None

    return score_results(annotations, judge, image_of, orig_of,
                         out_path=args.out, gt_of=gt_of)


def score_rise(args, judge):
    from bagel_tpu_torch.eval.scorers.rise import score_results

    with open(args.data) as f:
        items = json.load(f)
    if args.prompts:
        with open(args.prompts) as f:
            prompts = json.load(f)
    else:
        # canonical reference prompt bytes (eval/prompts/rise/), keyed by
        # the plan_judges prompt_keys
        from bagel_tpu_torch.eval.prompts import rise_defaults

        prompts = rise_defaults()

    def image_of(item):
        base = os.path.join(args.results_dir, item["category"])
        for suffix in ("png", "jpg", "jpeg"):
            p = os.path.join(base, f"{item['index']}.{suffix}")
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no output image for {item['index']}")

    def input_image_of(item):
        key = item.get("reference_img") or item.get("image")
        return os.path.join(args.input_dir, key)

    return score_results(items, judge, prompts, image_of, input_image_of)


def score_imgedit(args, judge):
    from bagel_tpu_torch.eval.scorers.imgedit import score_results

    with open(args.edit_json) as f:
        meta = json.load(f)
    with open(args.prompts) as f:
        prompts = json.load(f)
    return score_results(
        meta, prompts, judge,
        origin_of=lambda k, it: os.path.join(args.origin_root, it["id"]),
        result_of=lambda k, it: os.path.join(args.results_dir, f"{k}.png"),
        out_path=args.out,
    )


def score_wise(args, judge):
    """WISE over a gen_runner output directory: judge every sample image
    with the WiScore protocol prompt, then the published category/overall
    table (wise/gpt_eval_mp.py + cal_score.py, one command)."""
    from bagel_tpu_torch.eval.gen_scorer import iter_layout
    from bagel_tpu_torch.eval.scorers.judge import (
        build_wise_prompt, extract_wise_scores, run_judge, wise_summarize,
    )

    items = []
    for image_path, meta in iter_layout(args.results_dir):
        items.append({
            # id = (metadata index, sample filename): iter_layout yields the
            # SAME metadata dict for every samples/*.png in a folder, so the
            # bare index would collapse multi-sample layouts in the resume
            # done-set (ADVICE r4)
            "id": f"{meta.get('index', len(items))}:"
                  f"{os.path.basename(image_path)}",
            "images": [image_path],
            "prompt": meta.get("prompt", meta.get("Prompt", "")),
            "explanation": meta.get("explanation", meta.get("Explanation", "")),
            "meta": {"category": meta.get("category",
                                          meta.get("Subcategory", "all"))},
        })
    records = run_judge(
        items,
        build_prompt=lambda it: build_wise_prompt(it["prompt"],
                                                  it["explanation"]),
        judge=judge,
        extract=extract_wise_scores,
        out_path=f"{args.out}.records.jsonl" if args.out else None,
    )
    return wise_summarize(records)


def score_gedit(args, judge):
    """GEdit over a gen_runner edit-run output directory: the two-call
    VIEScore TIE protocol per sample (SC over [source, edited], PQ over
    [edited]), then the published group table (test_gedit_score.py +
    calculate_statistics.py, one command). Source images resolve through
    --origin_root + the metadata row's 'image' field (the same root the
    gen run used)."""
    from bagel_tpu_torch.eval.gen_scorer import iter_layout
    from bagel_tpu_torch.eval.scorers.judge import (
        JUDGE_FAILURE, gedit_summarize, vie_evaluate_tie,
    )

    items = []
    for image_path, meta in iter_layout(args.results_dir):
        items.append({
            # unique per sample image, not per folder (see score_wise)
            "id": f"{meta.get('index', len(items))}:"
                  f"{os.path.basename(image_path)}",
            "edited": image_path,
            "source": os.path.join(args.origin_root or "", meta["image"]),
            "instruction": meta.get("prompt", ""),
            "meta": {
                "group": meta.get("group", meta.get("task_type", "all")),
                "intersection_exist": meta.get("intersection_exist", False),
                "instruction_language": meta.get("instruction_language", ""),
            },
        })

    # two judge calls per sample -> a dedicated resumable loop (run_judge
    # is single-call; same record/out_path shape)
    out_path = f"{args.out}.records.jsonl" if args.out else None
    done, records = set(), []
    if out_path and os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                rec = json.loads(line)
                done.add(rec["id"])
                records.append(rec)
    fout = open(out_path, "a") if out_path else None
    try:
        for item in items:
            if item["id"] in done:
                continue
            try:
                sc, pq = vie_evaluate_tie(judge, item["source"],
                                          item["edited"],
                                          item["instruction"])
                rec = {"id": item["id"], **item["meta"],
                       "semantics_score": sc, "quality_score": pq}
            except Exception:
                rec = {"id": item["id"], **item["meta"],
                       "semantics_score": JUDGE_FAILURE,
                       "quality_score": JUDGE_FAILURE,
                       "judge_failed": True}
            records.append(rec)
            if fout:
                fout.write(json.dumps(rec) + "\n")
                fout.flush()
    finally:
        if fout:
            fout.close()
    # sentinel rows poison their group average like the reference's
    # failed-judgment skip; keep them visible in the table input
    return gedit_summarize(records)


def main(argv=None):
    ap = argparse.ArgumentParser("bagel_tpu_torch judge scorer")
    ap.add_argument("benchmark",
                    choices=["kris", "rise", "imgedit", "wise", "gedit"])
    ap.add_argument("--judge", required=True,
                    help="pkg.module:function -> (prompt, [paths]) -> str")
    ap.add_argument("--results_dir", required=True)
    ap.add_argument("--out", default=None, help="resume/output path prefix")
    # kris
    ap.add_argument("--bench_dir", default=None)
    ap.add_argument("--categories", nargs="*", default=None)
    # rise
    ap.add_argument("--data", default=None)
    ap.add_argument("--input_dir", default="data")
    # imgedit + rise
    ap.add_argument("--prompts", default=None)
    ap.add_argument("--edit_json", default=None)
    ap.add_argument("--origin_root", default=None)
    args = ap.parse_args(argv)

    judge = load_callable(args.judge)
    out = {"kris": score_kris, "rise": score_rise, "imgedit": score_imgedit,
           "wise": score_wise, "gedit": score_gedit}[args.benchmark](
        args, judge)
    print(json.dumps(out, indent=2, default=float))
    if args.out:
        with open(f"{args.out}.summary.json", "w") as f:
            json.dump(out, f, indent=2, default=float)


if __name__ == "__main__":
    main()
