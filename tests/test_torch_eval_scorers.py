"""The eval scorers: bagel_tpu_torch.eval's copies against bagel_tpu.eval's
on the same seeded rows. Every entry of vlm_runner.SCORERS (the judged ones
also with a deterministic judge), every judge_scorer benchmark (kris, rise,
imgedit, wise, gedit) with a deterministic judge callable,
gen_scorer.score_layout over given detections, and the HSV colour
classifier give identical outputs; the default detector is gated alike;
the judged flow (gen_runner, then judge_scorer through the HTTP judge
against a mock endpoint) gives JAX's summary on the same images."""

import argparse
import json
import random
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

from bagel_tpu.eval import detectors as jdetectors
from bagel_tpu.eval import gen_scorer as jgen_scorer
from bagel_tpu.eval import judge_scorer as jjudge_scorer
from bagel_tpu.eval import vlm_runner as jvlm_runner
from bagel_tpu.eval.scorers.geneval import Detection as JDetection
from bagel_tpu_torch.eval import detectors, gen_runner, gen_scorer, judge_scorer, vlm_runner
from bagel_tpu_torch.eval.scorers.geneval import Detection
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

YESNO = ["Yes", "no.", "Yes, there is one.", "maybe", "No there isn't", "", "the answer: no"]
CHOICE = ["A", "(B) a cat", "The answer is C", "D.", "none of them", "b", "I pick B because"]
WORDS = ["cat", "two dogs", "red", "3", "3.0", "forty-two", "a bus", "none"]
MME_TASKS = ["existence", "count", "OCR", "artwork", "code_reasoning"]
MMMU_SUBJECTS = ["Art", "Math", "Physics", "Accounting", "Biology"]


def _rows(name, seed=0, n=24):
    """n seeded result rows with the fields the scorer `name` reads."""
    rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
    pick = lambda xs: xs[int(rng.integers(len(xs)))]  # noqa: E731
    rows = []
    for i in range(n):
        r = {"index": i, "image": f"img{i // 2}.png", "question": f"question {i}?"}
        if name in ("yesno", "mme", "pope"):
            # MME pairs two questions an image within a task
            r.update(answer=pick(["yes", "no"]), prediction=pick(YESNO),
                     category=MME_TASKS[i // 2 % len(MME_TASKS)])
        elif name in ("choice", "mmbench"):
            opts = {k: pick(WORDS) + k for k in "ABCD"[: int(rng.integers(2, 5))]}
            r.update(answer=pick(list(opts)), prediction=pick(CHOICE), options=opts,
                     category=pick(MME_TASKS), index=i % 6 + 1_000_000 * (i // 6))
        elif name in ("exact", "numeric"):
            r.update(answer=pick(WORDS), prediction=f"it is {pick(WORDS)}.")
        elif name in ("mmmu", "mmmu_cot"):
            pred = pick(CHOICE) if i % 2 else f"The value is {pick(WORDS)}"
            if name == "mmmu_cot":
                pred = f"<think>hmm {pick(WORDS)}</think> Final Answer: {pred}"
            r.update(prediction=pred, category=pick(MMMU_SUBJECTS),
                     answer=pick(list("ABCD")) if i % 2 else pick(WORDS))
            if i % 2:
                r["options"] = {k: pick(WORDS) for k in "ABCD"}
        elif name == "mathvista":
            multi = bool(i % 2)
            choices = [pick(WORDS) for _ in range(3)] if multi else []
            r.update(question_type="multi_choice" if multi else "free_form",
                     answer_type="text" if multi else pick(["integer", "float"]),
                     precision=int(rng.integers(0, 3)), choices=choices,
                     answer=pick(choices) if multi else str(int(rng.integers(0, 9))),
                     prediction=pick(CHOICE) if multi else f"so x = {rng.integers(0, 9)}",
                     task=pick(["vqa", "figure qa"]), skills=[pick(["logic", "arith"])])
        elif name in ("vqa", "anls", "relaxed", "vqa_exact"):
            gts = [pick(WORDS) for _ in range(10)]
            r.update(gt_answers=gts, answer=gts[0], prediction=pick(WORDS + ["Two dogs!"]))
        elif name == "mmvp":
            opts = {"A": "pointing up", "B": "pointing down"}
            r.update(options=opts, answer=pick(["(a)", "(b)"]),
                     prediction=pick(["A", "B", "pointing down", "up", "?"]))
        elif name == "mmvet":
            r.update(answer=pick(["cat <OR> dog", "-1 <AND> -5", "red"]),
                     prediction=pick(["a dog", "x = -1", "red", "x = -1 or x = -5"]),
                     capability=pick(["rec,ocr", "ocr", "math,rec"]))
        else:
            raise KeyError(name)
        rows.append(r)
    return rows


def _judge_text(prompt, *images):
    """A deterministic judge: one of a few replies, chosen by the prompt."""
    replies = ["1.0", "The correctness score is 0.4", "B", "7", "0.0", "(A) the first"]
    return replies[zlib.crc32(prompt.encode()) % len(replies)]


def test_scorer_table_is_jax_table():
    assert list(vlm_runner.SCORERS) == list(jvlm_runner.SCORERS)
    assert vlm_runner._JUDGE_SCORERS == jvlm_runner._JUDGE_SCORERS


@pytest.mark.parametrize("name,judged", [(n, False) for n in jvlm_runner.SCORERS]
                         + [(n, True) for n in sorted(jvlm_runner._JUDGE_SCORERS)])
def test_vlm_scorer_matches_jax(name, judged):
    rows = _rows(name)
    kw = {"judge": _judge_text} if judged else {}
    # MMMU's parser picks a random option where nothing matches (as
    # upstream): both packages draw from the global `random`, seeded alike
    random.seed(0)
    want = jvlm_runner.SCORERS[name](json.loads(json.dumps(rows)), **kw)
    random.seed(0)
    got = vlm_runner.SCORERS[name](json.loads(json.dumps(rows)), **kw)
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)


# --------------------------------------------------------------------------
# judge_scorer benchmarks
# --------------------------------------------------------------------------

JUDGE_REPLIES = [
    '{"consistency_score": 4, "reasoning": "ok"}',
    '{"instruction_score": 3, "knowledge_score": 2, "reasoning": "r"}',
    '{"quality_score": 5, "reasoning": "q"}',
    "Final Score: 4", "Final Score: 1", "Final Score: 0",
    "Consistency: 2\nRealism: 1\nAesthetic Quality: 2",
    '{"score": [8, 6], "reasoning": "x"}', '{"score": [7], "reasoning": "y"}',
    "Instruction: 4\nQuality: 3\nOverall: 5", "unparseable",
]


def _judge(prompt, images):
    """A deterministic (prompt, image paths) -> text judge."""
    key = prompt + "|" + "|".join(p.rsplit("/", 1)[-1] for p in images)
    return JUDGE_REPLIES[zlib.crc32(key.encode()) % len(JUDGE_REPLIES)]


def _gen_layout(root, rows):
    for i, meta in enumerate(rows):
        d = root / f"{i:05d}" / "samples"
        d.mkdir(parents=True)
        Image.new("RGB", (8, 8), (i * 40 % 255, 20, 90)).save(d / "0000.png")
        (root / f"{i:05d}" / "metadata.jsonl").write_text(json.dumps({**meta, "index": i}) + "\n")


def _bench(bench, root):
    """(argparse namespace, files) of a small seeded `bench` run under root."""
    rng = np.random.default_rng(zlib.crc32(bench.encode()))
    res = root / "results"
    res.mkdir()
    ns = dict(results_dir=str(res), out=str(root / "scores"), categories=None,
              bench_dir=None, data=None, input_dir=str(root), prompts=None,
              edit_json=None, origin_root=str(root))
    if bench == "kris":
        ns["bench_dir"] = str(root / "bench")
        for cat in ("color_change", "chemistry", "viewpoint_change", "anomaly_correction",
                    "temporal_prediction", "abstract_reasoning"):
            (root / "bench" / cat).mkdir(parents=True)
            (res / cat).mkdir()
            ann = {str(k): {"ori_img": f"o{k}.png", "ins_en": f"edit {cat} {k}",
                            "explain_en": f"because {k}",
                            **({"gt_img": f"gt{k}.png"} if cat == "viewpoint_change" else {})}
                   for k in range(int(rng.integers(1, 4)))}
            (root / "bench" / cat / "annotation.json").write_text(json.dumps(ann))
    elif bench == "rise":
        items = []
        for k, cat in enumerate(["temporal_reasoning", "causal_reasoning", "spatial_reasoning",
                                 "logical_reasoning"] * 2):
            item = {"index": f"{cat}_{k}", "category": cat, "subtask": f"s{k % 3}",
                    "instruction": f"do {k}", "image": f"in{k}.png"}
            if k >= 4:
                item.update(reference_img=f"ref{k}.png", reasoning_img=f"r{k}.png",
                            reference_txt="answer 4", reference="answer 4")
            items.append(item)
            (res / cat).mkdir(exist_ok=True)
            Image.new("RGB", (4, 4)).save(res / cat / f"{item['index']}.png")
        (root / "data.json").write_text(json.dumps(items))
        ns["data"] = str(root / "data.json")
    elif bench == "imgedit":
        meta = {f"k{k}": {"id": f"o{k}.png", "edit_type": t, "prompt": f"{t} number {k}"}
                for k, t in enumerate(["replace", "adjust", "add", "replace", "remove"])}
        prompts = {t: f"Judge this {t}: <edit_prompt>. Reply lines."
                   for t in ("replace", "adjust", "add", "remove")}
        (root / "edit.json").write_text(json.dumps(meta))
        (root / "prompts.json").write_text(json.dumps(prompts))
        ns.update(edit_json=str(root / "edit.json"), prompts=str(root / "prompts.json"))
    elif bench == "wise":
        _gen_layout(res, [{"prompt": f"prompt {k}", "explanation": f"why {k}",
                           "category": ["cultural", "natural_science"][k % 2]}
                          for k in range(5)])
    elif bench == "gedit":
        _gen_layout(res, [{"prompt": f"edit {k}", "image": f"src{k}.png",
                           "group": ["background_change", "tone_transfer"][k % 2],
                           "intersection_exist": bool(k % 3), "instruction_language": "en"}
                          for k in range(5)])
    return argparse.Namespace(**ns)


@pytest.mark.parametrize("bench", ["kris", "rise", "imgedit", "wise", "gedit"])
def test_judge_scorer_matches_jax(bench, tmp_path):
    fns = {"kris": "score_kris", "rise": "score_rise", "imgedit": "score_imgedit",
           "wise": "score_wise", "gedit": "score_gedit"}
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = getattr(jjudge_scorer, fns[bench])(_bench(bench, tmp_path / "jax"), _judge)
    args = _bench(bench, tmp_path / "torch")
    got = getattr(judge_scorer, fns[bench])(args, _judge)
    assert json.dumps(got, sort_keys=True, default=float) == \
        json.dumps(want, sort_keys=True, default=float).replace(
            str(tmp_path / "jax"), str(tmp_path / "torch"))
    # resuming from the records: the same summary, no new judge call
    calls = []
    if bench in ("kris", "wise", "gedit", "imgedit"):
        again = getattr(judge_scorer, fns[bench])(args, lambda *a: calls.append(a))
        assert not calls and json.dumps(again, sort_keys=True, default=float) == \
            json.dumps(got, sort_keys=True, default=float)


# --------------------------------------------------------------------------
# GenEval: score_layout over given detections, the HSV colour classifier
# --------------------------------------------------------------------------

GENEVAL_META = [
    {"tag": "single_object", "include": [{"class": "dog", "count": 1}]},
    {"tag": "two_object", "include": [{"class": "dog", "count": 1}, {"class": "cat", "count": 1}]},
    {"tag": "counting", "include": [{"class": "cup", "count": 2}],
     "exclude": [{"class": "cup", "count": 3}]},
    {"tag": "colors", "include": [{"class": "car", "count": 1, "color": "red"}]},
    {"tag": "position", "include": [{"class": "dog", "count": 1},
                                    {"class": "cat", "count": 1, "position": ["left of", 0]}]},
    {"tag": "color_attr", "include": [{"class": "car", "count": 1, "color": "blue"},
                                      {"class": "cup", "count": 1, "color": "yellow"}]},
]
COLORS = {"red": (220, 20, 20), "blue": (20, 40, 220), "yellow": (235, 220, 30),
          "green": (30, 180, 40), "white": (245, 245, 245), "black": (5, 5, 5)}


def _scene(rng, path):
    """A 64 x 64 image of solid boxes, and its boxes by class."""
    img = np.full((64, 64, 3), 128, np.uint8)
    boxes = {}
    for cls in ("dog", "cat", "cup", "car"):
        for _ in range(int(rng.integers(0, 3))):
            x0, y0 = (int(v) for v in rng.integers(0, 44, 2))
            w, h = (int(v) for v in rng.integers(12, 20, 2))
            name = list(COLORS)[int(rng.integers(len(COLORS)))]
            img[y0:y0 + h, x0:x0 + w] = COLORS[name]
            boxes.setdefault(cls, []).append([x0, y0, x0 + w, y0 + h,
                                              float(rng.uniform(0.2, 1.0))])
    Image.fromarray(img).save(path)
    return boxes


@pytest.mark.parametrize("seed", [0, 1])
def test_score_layout_matches_jax(seed, tmp_path):
    rng = np.random.default_rng(seed)
    table = {}
    for i, meta in enumerate(GENEVAL_META * 2):
        d = tmp_path / f"{i:05d}" / "samples"
        d.mkdir(parents=True)
        (tmp_path / f"{i:05d}" / "metadata.jsonl").write_text(
            json.dumps({**meta, "prompt": f"prompt {i}"}) + "\n")
        table[str(d / "0000.png")] = _scene(rng, d / "0000.png")

    def detect(det_cls):
        return lambda path: {c: [det_cls(box=tuple(b[:4]), score=b[4]) for b in bs]
                             for c, bs in table[path].items()}

    kw = dict(threshold=0.3, counting_threshold=0.9, max_objects=16, nms_threshold=1.0)
    want = jgen_scorer.score_layout(str(tmp_path), detect(JDetection),
                                    classify_colors=jdetectors.classify_colors_hsv, **kw)
    got = gen_scorer.score_layout(str(tmp_path), detect(Detection),
                                  classify_colors=detectors.classify_colors_hsv, **kw)
    assert len(got) == 12 and got == want
    assert {r["correct"] for r in got} == {True, False}
    assert list(gen_scorer.iter_layout(str(tmp_path))) == \
        list(jgen_scorer.iter_layout(str(tmp_path)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classify_colors_hsv_matches_jax(seed, tmp_path):
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    for name, rgb in COLORS.items():  # a few solid patches among the noise
        x, y = (int(v) for v in rng.integers(0, 40, 2))
        img.paste(rgb, (x, y, x + 16, y + 12))
    dets = [[float(v) for v in (*rng.integers(0, 30, 2), *rng.integers(30, 64, 2))]
            for _ in range(6)]
    mask = rng.random((48, 64)) > 0.5
    dets.append(Detection(box=(0, 0, 64, 48), score=1.0, mask=mask))
    want = jdetectors.classify_colors_hsv(img, dets, "car")
    assert detectors.classify_colors_hsv(img, dets, "car") == want
    img.save(tmp_path / "x.png")
    assert detectors.classify_colors_hsv(str(tmp_path / "x.png"), dets[:3]) == \
        jdetectors.classify_colors_hsv(str(tmp_path / "x.png"), dets[:3])


def test_default_detector_gated_as_jax(monkeypatch, tmp_path):
    """Without torchvision both packages raise the same ImportError, which
    names the way around it (--detections / --detector)."""
    import sys

    monkeypatch.setitem(sys.modules, "torchvision", None)
    Image.new("RGB", (8, 8)).save(tmp_path / "x.png")
    errors = []
    for mod in (jdetectors, detectors):
        monkeypatch.setattr(mod, "_model", None)
        with pytest.raises(ImportError, match="torchvision is not installed") as e:
            mod.detect_default(str(tmp_path / "x.png"))
        errors.append(str(e.value))
    assert errors[1] == errors[0].replace("bagel_tpu.eval", "bagel_tpu_torch.eval")
    assert "--detections" in errors[1]


# --------------------------------------------------------------------------
# The judged flow: gen_runner -> judge_scorer through the HTTP judge
# --------------------------------------------------------------------------


class _MockJudge(BaseHTTPRequestHandler):
    """Replies in each protocol's format, as tests/test_judged_eval_e2e.py's."""

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        prompt, n_img = body["prompt"], len(body["images"])
        if "Consistency" in prompt and "Realism" in prompt:
            text = "Consistency: 2\nRealism: 1\nAesthetic Quality: 2"
        elif "Editing instruction:" in prompt:
            text = '{"score": [8, 6], "reasoning": "partial edit"}' if n_img == 2 else "bad"
        elif "naturalness" in prompt:
            text = '{"score": [7, 9], "reasoning": "fine"}'
        else:
            text = "unroutable prompt"
        payload = json.dumps({"text": text}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, *a):
        pass


@pytest.fixture
def judge_url(monkeypatch):
    server = ThreadingHTTPServer(("127.0.0.1", 0), _MockJudge)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    monkeypatch.setenv("BAGEL_JUDGE_URL",
                       f"http://127.0.0.1:{server.server_address[1]}/v1/judge")
    yield
    server.shutdown()
    server.server_close()
    t.join(timeout=10)


@pytest.mark.parametrize("bench", ["wise", "gedit"])
def test_judged_flow_matches_jax(bench, tmp_path, judge_url):
    rng = np.random.default_rng(3)
    if bench == "wise":
        rows = [{"prompt": "a rusted anchor", "explanation": "iron oxidizes",
                 "category": "natural_science"},
                {"prompt": "mid-autumn festival food", "explanation": "mooncakes",
                 "category": "cultural"}]
    else:
        rows = []
        for i, group in enumerate(["background_change", "tone_transfer"]):
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                tmp_path / f"src{i}.png")
            rows.append({"prompt": f"make it {group}", "image": f"src{i}.png", "group": group,
                         "intersection_exist": bool(i), "instruction_language": "en"})
    meta = tmp_path / "meta.jsonl"
    meta.write_text("\n".join(json.dumps(r) for r in rows))
    gen_runner.main(["--device", "cpu", "--max_kv", "512", "--image_size", "32",
                     "--num_timesteps", "2", "--cfg_text_scale", "2.0", "--timestep_shift", "1.0",
                     "--cfg_img_scale", "1.5", "--metadata", str(meta),
                     "--image_root", str(tmp_path), "--outdir", str(tmp_path / "gen")])
    summaries = []
    for pkg, mod in (("bagel_tpu", jjudge_scorer), ("bagel_tpu_torch", judge_scorer)):
        mod.main([bench, "--results_dir", str(tmp_path / "gen"), "--origin_root", str(tmp_path),
                  "--judge", f"{pkg}.eval.http_judge:judge", "--out", str(tmp_path / pkg)])
        summaries.append(json.loads((tmp_path / f"{pkg}.summary.json").read_text()))
        records = (tmp_path / f"{pkg}.records.jsonl").read_text().splitlines()
        assert len(records) == 2
    assert summaries[1] == summaries[0]
    if bench == "wise":
        # (2, 1, 2) everywhere: wiscore 1.8 / 2.0
        assert summaries[1]["overall"] == pytest.approx(0.9)
    else:
        for g in ("background_change", "tone_transfer"):
            row = summaries[1]["full"]["groups"][g]
            assert row["SC"] == 6 and row["PQ"] == 7 and row["n"] == 1
