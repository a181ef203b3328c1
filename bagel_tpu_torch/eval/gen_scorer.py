"""Score a GenEval-layout results directory.

Walks outdir/{index:05d}/{metadata.jsonl, samples/*.png} (the layout
gen_runner emits, identical to the reference's gen_images_mp.py output),
runs a detector per image, applies the GenEval rule engine
(eval/scorers/geneval.py) and prints the published per-task table +
overall.

The detector is pluggable because mmdet/Mask2Former is an external model:
  --detector pkg.module:function   a callable
      (image_path) -> {classname: [(x0, y0, x1, y1, score), ...]}
  --detections dets.jsonl          precomputed boxes, one JSON object per
      image: {"filename": ..., "boxes": {classname: [[x0,y0,x1,y1,score]]}}

A color classifier can be plugged the same way (--color_classifier);
without one, color clauses fail closed with a clear reason.

  python -m bagel_tpu_torch.eval.gen_scorer --outdir results/ \
      --detections dets.jsonl --out results/geneval.jsonl
"""

from __future__ import annotations

import argparse
import sys
import importlib
import json
import os
import re
from typing import Callable, Dict, List

from bagel_tpu_torch.eval.scorers.geneval import (
    Detection,
    evaluate_sample,
    filter_detections,
    summarize,
)


def _load_callable(spec: str) -> Callable:
    mod, _, fn = spec.partition(":")
    return getattr(importlib.import_module(mod), fn)


def _boxes_to_detections(boxes: Dict[str, List]) -> Dict[str, List[Detection]]:
    return {
        cls: [Detection(box=tuple(b[:4]), score=float(b[4])) for b in items]
        for cls, items in boxes.items()
    }


def iter_layout(outdir: str):
    """Yield (image_path, metadata) over the GenEval directory layout."""
    for sub in sorted(os.listdir(outdir)):
        folder = os.path.join(outdir, sub)
        if not os.path.isdir(folder) or not sub.isdigit():
            continue
        meta_path = os.path.join(folder, "metadata.jsonl")
        if not os.path.exists(meta_path):
            continue
        with open(meta_path) as f:
            metadata = json.loads(f.readline())
        samples = os.path.join(folder, "samples")
        if not os.path.isdir(samples):
            continue
        for name in sorted(os.listdir(samples)):
            if re.fullmatch(r"\d+\.png", name):
                yield os.path.join(samples, name), metadata


def score_layout(
    outdir: str,
    detect: Callable[[str], Dict[str, List[Detection]]],
    classify_colors=None,
    **filter_kwargs,
) -> List[dict]:
    results = []
    for image_path, metadata in iter_layout(outdir):
        filtered = filter_detections(
            detect(image_path), tag=metadata["tag"], **filter_kwargs
        )
        correct, reason = evaluate_sample(
            filtered, metadata, classify_colors=classify_colors,
            image=image_path,
        )
        results.append({
            "filename": image_path,
            "tag": metadata["tag"],
            "prompt": metadata.get("prompt", ""),
            "correct": correct,
            "reason": reason,
            "metadata": json.dumps(metadata, sort_keys=True),
        })
    return results


def main(argv=None):
    p = argparse.ArgumentParser("bagel_tpu_torch geneval scorer")
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--out", type=str, default=None,
                   help="per-image results jsonl (default outdir/geneval.jsonl)")
    p.add_argument("--detector", type=str, default=None,
                   help="pkg.module:function detector callable")
    p.add_argument("--detections", type=str, default=None,
                   help="precomputed detections jsonl")
    p.add_argument("--color_classifier", type=str, default=None)
    p.add_argument("--threshold", type=float, default=0.3)
    p.add_argument("--counting_threshold", type=float, default=0.9)
    p.add_argument("--max_objects", type=int, default=16)
    p.add_argument("--nms_threshold", type=float, default=1.0)
    args = p.parse_args(argv)

    if not args.detector and not args.detections:
        # built-in default (eval/detectors.py): torchvision Mask R-CNN —
        # runs end-to-end with no external env, but is score-shifted vs
        # the reference's mmdet Mask2Former (weaker detector); absolute
        # numbers are not comparable to the published table
        args.detector = "bagel_tpu_torch.eval.detectors:detect_default"
        print("# no --detector/--detections: using the built-in "
              "torchvision Mask R-CNN default (score-shifted vs the "
              "reference's mmdet Mask2Former; see eval/detectors.py)",
              file=sys.stderr)

    if args.detections:
        table: Dict[str, Dict] = {}
        with open(args.detections) as f:
            for line in f:
                rec = json.loads(line)
                table[os.path.normpath(rec["filename"])] = rec["boxes"]

        def detect(path):
            return _boxes_to_detections(table.get(os.path.normpath(path), {}))
    else:
        raw_fn = _load_callable(args.detector)

        def detect(path):
            return _boxes_to_detections(raw_fn(path))

    if args.color_classifier:
        classify = _load_callable(args.color_classifier)
    else:
        # CLIP-free default: HSV majority vote (eval/detectors.py)
        from bagel_tpu_torch.eval.detectors import classify_colors_hsv as classify
    results = score_layout(
        args.outdir, detect, classify_colors=classify,
        threshold=args.threshold, counting_threshold=args.counting_threshold,
        max_objects=args.max_objects, nms_threshold=args.nms_threshold,
    )
    out_path = args.out or os.path.join(args.outdir, "geneval.jsonl")
    with open(out_path, "w") as f:
        for r in results:
            f.write(json.dumps(r) + "\n")
    summary = summarize(results)
    with open(os.path.splitext(out_path)[0] + "_summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
