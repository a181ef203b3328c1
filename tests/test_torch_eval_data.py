"""The eval data tools: bagel_tpu_torch's data_prep (the preps over local
files, through `main`) and make_parquet_info against bagel_tpu's, on the
same seeded inputs. Bars: identical jsonl rows and image files, and an
identical parquet_info dict."""

import base64
import json

import numpy as np
import pytest

from bagel_tpu.data import make_parquet_info as jmake_parquet_info
from bagel_tpu.eval import data_prep as jdata_prep
from bagel_tpu_torch.data import make_parquet_info
from bagel_tpu_torch.eval import data_prep
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)


def _inputs(bench, root, rng):
    """Seeded benchmark files of `bench` under root; `main`'s arguments."""
    root.mkdir(parents=True)
    out = str(root / "out.jsonl")
    pick = lambda xs: xs[int(rng.integers(len(xs)))]  # noqa: E731
    if bench == "mmbench":
        lines = ["index\tquestion\thint\tA\tB\tC\tD\tanswer\tcategory\timage"]
        for i in range(5):
            img = base64.b64encode(rng.bytes(16)).decode()
            opts = [pick(["red", "blue", "a cat", "two"]) if k < 2 + i % 3 else ""
                    for k in range(4)]
            hint = pick(["Look closely", "nan", ""])
            lines.append("\t".join([str(10 + i), f"What is {i}?", hint, *opts,
                                    pick("AB"), pick(["color", "count"]), img]))
        (root / "mm.tsv").write_text("\n".join(lines) + "\n")
        return ["mmbench", "--tsv", str(root / "mm.tsv"), "--out", out,
                "--image_dir", str(root / "imgs")]
    if bench == "mme":
        for task in ("color", "OCR"):
            (root / "mme" / task / "images").mkdir(parents=True)
            rows = []
            for i in range(3):
                (root / "mme" / task / "images" / f"x{i}.jpg").write_bytes(rng.bytes(8))
                rows += [f"x{i}.jpg\tIs it {k}?\t{pick(['Yes', 'No'])}" for k in ("a", "b")]
            (root / "mme" / f"{task}.txt").write_text("\n".join(rows) + "\n")
        return ["mme", "--root", str(root / "mme"), "--out", out]
    if bench == "pope":
        (root / "q.jsonl").write_text("\n".join(json.dumps({
            "question_id": i, "image": f"p{i}.jpg", "text": f"Is there a dog {i}?",
            "label": pick(["Yes", "No"])}) for i in range(5)))
        return ["pope", "--questions", str(root / "q.jsonl"), "--out", out,
                "--image_dir", "root"]
    if bench == "wise":
        (root / "wise.json").write_text(json.dumps([
            {"prompt_id": 11 + i, "Prompt": f"prompt {i}", "Explanation": f"why {i}",
             "Subcategory": pick(["Chemistry", "Biology"])} for i in range(4)]))
        return ["wise", "--prompts", str(root / "wise.json"), "--out", out]
    if bench == "mmvp":
        (root / "MMVP").mkdir()
        rows = ["Index,Question,Options,Correct Answer"]
        rows += [f"{i},Which way {i}?,(a) up (b) down,{pick(['(a)', '(b)'])}" for i in range(1, 7)]
        (root / "MMVP" / "Questions.csv").write_text("\n".join(rows) + "\n")
        return ["mmvp", "--root", str(root / "MMVP"), "--out", out]
    if bench == "vqa":
        (root / "test.jsonl").write_text("\n".join(json.dumps({
            "image": f"i/{i}.jpg", "question": f"How many {i}?", "question_id": i})
            for i in range(4)))
        (root / "ann.json").write_text(json.dumps({"annotations": [
            {"question_id": i, "answers": [{"answer": pick(["2", "two", "3"])}
                                           for _ in range(10)]} for i in range(4)]}))
        return ["vqa", "--test", str(root / "test.jsonl"), "--out", out,
                "--annotation", str(root / "ann.json"), "--image_dir", "imgs"]
    if bench == "mmvet":
        (root / "q.jsonl").write_text("\n".join(json.dumps({
            "question_id": i, "image": f"x{i}.png", "text": f"what {i}?",
            "answer": "cat <OR> dog", "capability": ["rec", "ocr"][: 1 + i % 2]})
            for i in range(4)))
        return ["mmvet", "--questions", str(root / "q.jsonl"), "--out", out,
                "--image_dir", "imgs"]
    raise KeyError(bench)


@pytest.mark.parametrize("bench", ["mmbench", "mme", "pope", "wise", "mmvp", "vqa", "mmvet"])
def test_data_prep_matches_jax(bench, tmp_path):
    outs = []
    for name, mod in (("jax", jdata_prep), ("torch", data_prep)):
        root = tmp_path / name
        mod.main(_inputs(bench, root, np.random.default_rng(len(bench))))
        text = (root / "out.jsonl").read_text()
        outs.append(text.replace(str(root), "<root>"))
        written = sorted(p.relative_to(root) for p in root.rglob("*")
                         if p.is_file() and p.name != "out.jsonl")
        outs.append([(str(p), (root / p).read_bytes()) for p in written])
    assert outs[2] == outs[0] and outs[3] == outs[1]
    assert len(outs[2].splitlines()) >= 4


def test_build_parquet_info_matches_jax(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(0)
    dirs = []
    for d in range(2):
        (tmp_path / f"d{d}").mkdir()
        dirs.append(str(tmp_path / f"d{d}"))
        for f in range(3):
            n = int(rng.integers(3, 40))
            pq.write_table(pa.Table.from_pylist([{"a": i} for i in range(n)]),
                           tmp_path / f"d{d}" / f"part{f}.parquet",
                           row_group_size=int(rng.integers(2, 9)))
        (tmp_path / f"d{d}" / "skip.txt").write_text("x")
    want = jmake_parquet_info.build_parquet_info(dirs)
    got = make_parquet_info.build_parquet_info(dirs)
    assert got == want and len(got) == 6
    assert len({v["num_row_groups"] for v in got.values()}) > 1
    make_parquet_info.main([*dirs, "-o", str(tmp_path / "info.json")])
    assert json.loads((tmp_path / "info.json").read_text()) == want
