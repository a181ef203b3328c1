"""Benchmark data preparation: published formats -> the runners' jsonl.

The reference's eval dirs assume pre-downloaded benchmark dumps in each
suite's native format (MMBench base64-TSV, MME per-task txt files, POPE
question jsonl, MMMU / MathVista HuggingFace datasets, WISE prompt json).
These converters normalize them into the row schema
`bagel_tpu_torch.eval.vlm_runner` / `gen_runner` consume:

    {"index", "question" | "prompt", "image" (path, optional), "answer",
     "options" ({letter: text}, optional), "category", ...extra fields the
     benchmark's scorer needs}

Network-dependent sources (HF `datasets`) are import-guarded — the
converters that only reshape local files run anywhere.

  python -m bagel_tpu_torch.eval.data_prep mmbench --tsv mmbench_dev.tsv \
      --out mmbench.jsonl --image_dir images/mmbench
  python -m bagel_tpu_torch.eval.data_prep mme --root MME_release --out mme.jsonl
  python -m bagel_tpu_torch.eval.data_prep pope --questions llava_pope_test.jsonl \
      --out pope.jsonl
"""

from __future__ import annotations

import argparse
import base64
import csv
import io
import json
import os
from typing import Optional

# reference prompt suffixes (evaluate_mmbench.py:279-282, mme/eval.py:43,
# pope/evaluate_pope.py)
MMBENCH_PROMPT_EN = "Answer with the option's letter from the given choices directly."
MME_PROMPT = "Answer the question using a single word or phrase."
POPE_PROMPT = "Answer the question using a single word or phrase."

OPTION_LETTERS = ["A", "B", "C", "D", "E", "F", "G", "H", "I"]


def prep_mmbench(tsv_path: str, out_jsonl: str, image_dir: str,
                 language: str = "en") -> int:
    """MMBench dev TSV (base64 images, A-E option columns) -> jsonl + image
    files. Question text = [hint\\n]question + options + answer prompt
    (evaluate_mmbench.py:92-118)."""
    os.makedirs(image_dir, exist_ok=True)
    n = 0
    with open(tsv_path, newline="", encoding="utf-8") as f, \
            open(out_jsonl, "w") as out:
        for row in csv.DictReader(f, delimiter="\t"):
            idx = int(row["index"])
            img_path = os.path.join(image_dir, f"{idx}.jpg")
            if not os.path.exists(img_path):
                with open(img_path, "wb") as imf:
                    imf.write(base64.b64decode(row["image"]))
            options = {
                c: row[c] for c in OPTION_LETTERS
                if row.get(c) not in (None, "", "nan")
            }
            q = row["question"]
            if row.get("hint") not in (None, "", "nan"):
                q = row["hint"] + "\n" + q
            for key, item in options.items():
                q += f"\n{key}. {item}"
            q += "\n" + (MMBENCH_PROMPT_EN if language == "en" else "请直接回答选项字母。")
            out.write(json.dumps({
                "index": idx,
                "question": q,
                "image": img_path,
                "answer": row.get("answer", ""),
                "options": options,
                "category": row.get("category", "all"),
            }) + "\n")
            n += 1
    return n


def prep_mme(root: str, out_jsonl: str) -> int:
    """MME release layout: per-task `<task>.txt` question files with
    `img\\tquestion\\tanswer` lines; images at <task>/<img> or
    <task>/images/<img> (mme/eval.py:44-56)."""
    n = 0
    with open(out_jsonl, "w") as out:
        for entry in sorted(os.listdir(root)):
            if not entry.endswith(".txt"):
                continue
            task = entry[: -len(".txt")]
            with open(os.path.join(root, entry), encoding="utf-8") as f:
                for line in f:
                    if not line.strip():
                        continue
                    img, question, gt = line.strip().split("\t")
                    img_path = os.path.join(task, img)
                    if not os.path.exists(os.path.join(root, img_path)):
                        img_path = os.path.join(task, "images", img)
                    out.write(json.dumps({
                        "index": n,
                        "question": question + " " + MME_PROMPT,
                        "image": img_path,
                        "answer": gt.strip().lower(),
                        "category": task,
                    }) + "\n")
                    n += 1
    return n


def prep_pope(questions_jsonl: str, out_jsonl: str,
              image_dir: str = "") -> int:
    """POPE llava-format question jsonl ({question_id, image, text|question,
    label|answer}) -> runner rows."""
    n = 0
    with open(questions_jsonl) as f, open(out_jsonl, "w") as out:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            q = row.get("text") or row.get("question")
            out.write(json.dumps({
                "index": row.get("question_id", n),
                "question": q + " " + POPE_PROMPT,
                "image": os.path.join(image_dir, row["image"]),
                "answer": str(row.get("label") or row.get("answer", "")).lower(),
                "category": row.get("category", "all"),
            }) + "\n")
            n += 1
    return n


def prep_wise(prompts_json: str, out_jsonl: str) -> int:
    """WISE prompt json (list of {prompt_id|PromptID, Prompt,
    Subcategory...}) -> gen_runner metadata jsonl."""
    with open(prompts_json) as f:
        data = json.load(f)
    n = 0
    with open(out_jsonl, "w") as out:
        for row in data:
            out.write(json.dumps({
                "index": row.get("prompt_id", row.get("PromptID", n)),
                "prompt": row.get("Prompt") or row.get("prompt"),
                "category": row.get("Subcategory")
                or row.get("Category", "all"),
            }) + "\n")
            n += 1
    return n


def prep_mmmu(out_jsonl: str, image_dir: str, split: str = "validation",
              subjects: Optional[list] = None) -> int:
    """MMMU via HuggingFace `datasets` (network / pre-downloaded cache
    required). Options list -> {letter: text}; images extracted to files."""
    from datasets import get_dataset_config_names, load_dataset  # guarded

    import ast

    os.makedirs(image_dir, exist_ok=True)
    subjects = subjects or get_dataset_config_names("MMMU/MMMU")
    n = 0
    with open(out_jsonl, "w") as out:
        for subject in subjects:
            ds = load_dataset("MMMU/MMMU", subject, split=split)
            for row in ds:
                opts = row.get("options")
                if isinstance(opts, str):
                    opts = ast.literal_eval(opts)
                options = {
                    OPTION_LETTERS[i]: o for i, o in enumerate(opts or [])
                }
                img = row.get("image_1")
                img_path = None
                if img is not None:
                    img_path = os.path.join(image_dir, f"{row['id']}.png")
                    if not os.path.exists(img_path):
                        img.convert("RGB").save(img_path)
                q = row["question"]
                for key, item in options.items():
                    q += f"\n{key}. {item}"
                out.write(json.dumps({
                    "index": row["id"],
                    "question": q,
                    "image": img_path,
                    "answer": row.get("answer", ""),
                    "options": options,
                    "category": subject,
                    "question_type": (
                        "multiple-choice" if options else "open"
                    ),
                }) + "\n")
                n += 1
    return n


def prep_mathvista(out_jsonl: str, image_dir: str,
                   split: str = "testmini") -> int:
    """MathVista testmini via HuggingFace `datasets` (guarded)."""
    from datasets import load_dataset  # guarded

    os.makedirs(image_dir, exist_ok=True)
    ds = load_dataset("AI4Math/MathVista", split=split)
    n = 0
    with open(out_jsonl, "w") as out:
        for row in ds:
            img = row.get("decoded_image")
            img_path = None
            if img is not None:
                img_path = os.path.join(image_dir, f"{row['pid']}.png")
                if not os.path.exists(img_path):
                    img.convert("RGB").save(img_path)
            meta = row.get("metadata") or {}
            out.write(json.dumps({
                "index": row["pid"],
                "question": row.get("query") or row.get("question"),
                "image": img_path,
                "answer": row.get("answer", ""),
                "choices": row.get("choices"),
                "question_type": row.get("question_type", ""),
                "answer_type": row.get("answer_type", ""),
                "precision": row.get("precision", 0),
                "task": meta.get("task", "all"),
                "skills": meta.get("skills", []),
            }) + "\n")
            n += 1
    return n


def prep_mmvp(root: str, out_jsonl: str) -> int:
    """MMVP release dir (Questions.csv + 'MMVP Images/') -> paired runner
    rows. Question text = question + lettered options + the option-letter
    prompt; gt '(a)' -> 'A' (evaluate_mmvp.py:59-95)."""
    from bagel_tpu_torch.eval.scorers.mmvp import normalize_gt, parse_options

    n = 0
    with open(os.path.join(root, "Questions.csv"), newline="",
              encoding="utf-8") as f, open(out_jsonl, "w") as out:
        for row in csv.DictReader(f):
            data_id = row.get("lndex") or row["Index"]  # sic: source typo
            options = parse_options(row["Options"])
            q = row["Question"]
            for letter, text in options.items():
                q += f"\n{letter}. {text}"
            q += "\n" + MMBENCH_PROMPT_EN
            out.write(json.dumps({
                "index": data_id,
                "question": q,
                "image": os.path.join("MMVP Images", f"{data_id}.jpg"),
                "answer": normalize_gt(row.get("Correct Answer", "")),
                "options": options,
            }) + "\n")
            n += 1
    return n


def prep_vqa(test_jsonl: str, out_jsonl: str,
             annotation_json: str = "", image_dir: str = "",
             prompt: str = MME_PROMPT) -> int:
    """Reference VQA test jsonl ({image, question, question_id, answer?})
    joined with the official annotations json ({'annotations': [{question_id,
    answers: [{answer}, ...]}]}) -> rows carrying gt_answers for the EvalAI
    soft scorer (evaluate_vqa.py:243-263, 423-434). Without annotations the
    per-row 'answer' field rides along (anls/relaxed/exact suites)."""
    qid2answers = {}
    if annotation_json:
        with open(annotation_json) as f:
            for item in json.load(f)["annotations"]:
                qid2answers[item["question_id"]] = [
                    a["answer"] for a in item["answers"]
                ]
    n = 0
    with open(test_jsonl) as f, open(out_jsonl, "w") as out:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            qid = row.get("question_id", n)
            rec = {
                "index": qid,
                "question": (row.get("question") or row.get("text", ""))
                + (" " + prompt if prompt else ""),
                "image": os.path.join(image_dir, row["image"]),
                "answer": row.get("answer", ""),
            }
            if qid in qid2answers:
                rec["gt_answers"] = qid2answers[qid]
            elif row.get("answer") is not None:
                rec["annotation"] = row["answer"]
            out.write(json.dumps(rec) + "\n")
            n += 1
    return n


def prep_mmvet(questions_jsonl: str, out_jsonl: str,
               image_dir: str = "") -> int:
    """MM-Vet llava-format jsonl ({question_id, image, text, answer?,
    capability?}) -> runner rows (evaluate_mmvet.py:43-56; no prompt
    suffix — free-form answers)."""
    n = 0
    with open(questions_jsonl) as f, open(out_jsonl, "w") as out:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            caps = row.get("capability")
            if isinstance(caps, list):
                caps = ",".join(caps)
            out.write(json.dumps({
                "index": row.get("question_id", n),
                "question_id": row.get("question_id", n),
                "question": row.get("text") or row.get("question", ""),
                "image": os.path.join(image_dir, row["image"]),
                "answer": row.get("answer", ""),
                "capability": caps or "",
            }) + "\n")
            n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser("bagel_tpu_torch benchmark data prep")
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("mmbench")
    b.add_argument("--tsv", required=True)
    b.add_argument("--out", required=True)
    b.add_argument("--image_dir", required=True)
    b.add_argument("--language", default="en")
    m = sub.add_parser("mme")
    m.add_argument("--root", required=True)
    m.add_argument("--out", required=True)
    p = sub.add_parser("pope")
    p.add_argument("--questions", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--image_dir", default="")
    w = sub.add_parser("wise")
    w.add_argument("--prompts", required=True)
    w.add_argument("--out", required=True)
    u = sub.add_parser("mmmu")
    u.add_argument("--out", required=True)
    u.add_argument("--image_dir", required=True)
    u.add_argument("--split", default="validation")
    v = sub.add_parser("mathvista")
    v.add_argument("--out", required=True)
    v.add_argument("--image_dir", required=True)
    v.add_argument("--split", default="testmini")
    mp = sub.add_parser("mmvp")
    mp.add_argument("--root", required=True,
                    help="MMVP release dir (Questions.csv + 'MMVP Images/')")
    mp.add_argument("--out", required=True)
    vq = sub.add_parser("vqa")
    vq.add_argument("--test", required=True)
    vq.add_argument("--out", required=True)
    vq.add_argument("--annotation", default="",
                    help="official annotations json (vqa_score suites)")
    vq.add_argument("--image_dir", default="")
    vq.add_argument("--prompt", default=MME_PROMPT)
    mv = sub.add_parser("mmvet")
    mv.add_argument("--questions", required=True)
    mv.add_argument("--out", required=True)
    mv.add_argument("--image_dir", default="")
    args = ap.parse_args(argv)

    if args.cmd == "mmbench":
        n = prep_mmbench(args.tsv, args.out, args.image_dir, args.language)
    elif args.cmd == "mme":
        n = prep_mme(args.root, args.out)
    elif args.cmd == "pope":
        n = prep_pope(args.questions, args.out, args.image_dir)
    elif args.cmd == "wise":
        n = prep_wise(args.prompts, args.out)
    elif args.cmd == "mmmu":
        n = prep_mmmu(args.out, args.image_dir, args.split)
    elif args.cmd == "mmvp":
        n = prep_mmvp(args.root, args.out)
    elif args.cmd == "vqa":
        n = prep_vqa(args.test, args.out, args.annotation, args.image_dir,
                     args.prompt)
    elif args.cmd == "mmvet":
        n = prep_mmvet(args.questions, args.out, args.image_dir)
    else:
        n = prep_mathvista(args.out, args.image_dir, args.split)
    print(f"wrote {n} rows to {args.out}")


if __name__ == "__main__":
    main()
