"""The eval runners: bagel_tpu_torch.eval's gen_runner and vlm_runner
against bagel_tpu.eval's, on tiny_bagel with the same bridged random
weights (every leaf perturbed, llm2vae included), CPU fp32.

Bars: `run_eval`'s predictions identical to JAX's (greedy) at batch sizes 1
and 2 and with --think; `run_gen`'s PNGs within one uint8 level of JAX's
`main` loop given the same x_1 (and, for an edit, JAX's posterior draw),
its metadata files identical, and a second run writes nothing; both
command lines write JAX's layout on the micro weights; `vlm_runner.main`
over two gloo processes writes the one-process results file."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_bagel
from bagel_tpu.data import transforms as jtransforms
from bagel_tpu.data.tokenizer import MockTokenizer as JMockTokenizer
from bagel_tpu.eval import gen_runner as jgen_runner
from bagel_tpu.eval import vlm_runner as jvlm_runner
from bagel_tpu.inference.engine import BagelEngine as JEngine
from bagel_tpu.models import bagel as jbagel
from bagel_tpu_torch.data import transforms as ttransforms
from bagel_tpu_torch.data.tokenizer import MockTokenizer
from bagel_tpu_torch.eval import gen_runner, vlm_runner
from bagel_tpu_torch.inference.engine import BagelEngine
from bagel_tpu_torch.models import vae as tvae
from bagel_tpu_torch.utils.bridge import params_from_numpy

from test_torch_edit import jax_normal
from test_torch_qwen2 import randomized
from torch_test_env import port_limits, reaped  # noqa: F401 (port_limits: autouse)

REPO = Path(__file__).resolve().parents[1]
GEN = ["--image_size", "32", "--num_timesteps", "3", "--cfg_text_scale", "2.0",
       "--timestep_shift", "1.0", "--cfg_img_scale", "1.5"]
MICRO = ["--device", "cpu", "--max_kv", "512"]


@pytest.fixture(scope="module")
def engines():
    cfg = tiny_bagel()
    tree = randomized(jbagel.init_bagel_params(jax.random.PRNGKey(0), cfg, jnp.float32), 13)
    tree["llm"]["lm_head"]["w"] = tree["llm"]["lm_head"]["w"] * 8.0  # no near ties
    jtok, ttok = JMockTokenizer(cfg.llm.vocab_size), MockTokenizer(cfg.llm.vocab_size)
    # 32 x 32 px for the VAE (stride 16 keeps it), 56 x 56 for the ViT
    jvae, tvae_tf = jtransforms.ImageTransform(64, 16, 16), ttransforms.ImageTransform(64, 16, 16)
    jvit = jtransforms.ImageTransform(56, 28, 14, max_pixels=56 * 56)
    tvit = ttransforms.ImageTransform(56, 28, 14, max_pixels=56 * 56)
    jeng = JEngine(jax.tree.map(jnp.asarray, tree), cfg, jtok, jtok.new_token_ids,
                   max_kv=512, vae_transform=jvae)
    teng = BagelEngine(params_from_numpy(tree, "cpu"), cfg, ttok, ttok.new_token_ids,
                       max_kv=512, vae_transform=tvae_tf, device="cpu")
    return cfg, (jeng, jvae, jvit), (teng, tvae_tf, tvit)


def _png(path, rng, h, w):
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(path)


def _vqa_rows(root, n, px=56):
    """n rows with an image (px x px, every other row 14 px shorter, at
    least 28) and one without."""
    rng = np.random.default_rng(5)
    rows = []
    for i in range(n):
        _png(root / f"q{i}.png", rng, max(px - 14 * (i % 2), 28), px)
        rows.append({"image": f"q{i}.png", "question": f"is there a cat number {i}?",
                     "answer": "yes" if i % 2 else "no", "category": "c" + str(i % 2)})
    rows.append({"question": "a question with no image", "answer": "no"})
    return [dict(r, index=i) for i, r in enumerate(rows)]


@pytest.mark.parametrize("batch_size,think", [(1, False), (2, False), (1, True)])
def test_run_eval_matches_jax(engines, tmp_path, batch_size, think):
    _, (jeng, _, jvit), (teng, _, tvit) = engines
    rows = _vqa_rows(tmp_path, 3)
    n = 4 if think else 6
    with jax.default_matmul_precision("float32"):
        want = jvlm_runner.run_eval(jeng, jvit, rows, str(tmp_path), n, think, batch_size)
    got = vlm_runner.run_eval(teng, tvit, rows, str(tmp_path), n, think, batch_size)
    assert [r["prediction"] for r in got] == [r["prediction"] for r in want]
    assert got == want
    assert all(r["prediction"] for r in got)


def _gen_rows(root):
    _png(root / "src.png", np.random.default_rng(6), 32, 32)
    return [{"prompt": "a red cube on a table", "tag": "single_object", "index": 0},
            {"prompt": "make the cube blue", "image": "src.png", "index": 3}]


def _with_noise(eng, noise):
    """eng.gen_image with x_1 given, whatever rng the runner passes."""
    orig = eng.gen_image

    def gen_image(*a, **kw):
        kw.pop("init_noise", None)
        return orig(*a, init_noise=noise, **kw)

    return gen_image


def _layout(outdir):
    return sorted(str(p.relative_to(outdir)) for p in Path(outdir).rglob("*") if p.is_file())


def test_run_gen_matches_jax(engines, tmp_path, monkeypatch):
    cfg, (jeng, jvae, jvit), (teng, tvae_tf, _) = engines
    rows = _gen_rows(tmp_path)
    meta = tmp_path / "meta.jsonl"
    meta.write_text("\n".join(json.dumps(r) for r in rows))
    n = (32 // cfg.latent_downsample) ** 2
    noise = np.random.default_rng(7).standard_normal((n, cfg.patch_latent_dim)).astype(np.float32)
    # JAX's posterior draw for the edit row's VAE encode
    monkeypatch.setattr(tvae, "_posterior_noise",
                        lambda shape, generator, device: torch.tensor(jax_normal(shape)))
    monkeypatch.setattr(jeng, "gen_image", _with_noise(jeng, noise))
    monkeypatch.setattr(teng, "gen_image", _with_noise(teng, noise))
    import bagel_tpu.serving.app as japp

    monkeypatch.setattr(japp, "build_engine", lambda args: (jeng, jvae, jvit))
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    flags = GEN + ["--metadata", str(meta), "--image_root", str(tmp_path)]
    with jax.default_matmul_precision("float32"):
        jgen_runner.main(flags + ["--outdir", str(jdir)])
    args = gen_runner.parse_args(flags + ["--outdir", str(tdir)])
    assert gen_runner.run_gen(teng, tvae_tf, rows, str(tdir), args) == [0, 3]

    assert _layout(tdir) == _layout(jdir) == [
        "00000/metadata.jsonl", "00000/samples/0000.png",
        "00003/metadata.jsonl", "00003/samples/0000.png"]
    for idx in ("00000", "00003"):
        assert (tdir / idx / "metadata.jsonl").read_bytes() == \
            (jdir / idx / "metadata.jsonl").read_bytes()
        got = np.asarray(Image.open(tdir / idx / "samples" / "0000.png"), np.int16)
        want = np.asarray(Image.open(jdir / idx / "samples" / "0000.png"), np.int16)
        assert got.shape == want.shape == (32, 32, 3)
        assert np.abs(got - want).max() <= 1, idx
        assert want.std() > 0
    # resuming: every image exists, so nothing is generated or rewritten
    stamp = {p: p.stat().st_mtime_ns for p in tdir.rglob("*.png")}
    assert gen_runner.run_gen(teng, tvae_tf, rows, str(tdir), args) == []
    assert {p: p.stat().st_mtime_ns for p in tdir.rglob("*.png")} == stamp


def test_run_gen_shards_by_rank(engines, tmp_path):
    """rank r of w takes rows[r::w] (the JAX runner's process split), and
    each row's x_1 is a torch.Generator seeded seed + index."""
    _, _, (teng, tvae_tf, _) = engines
    rows = [{"prompt": f"prompt {i}", "index": i} for i in range(3)]
    args = gen_runner.parse_args(GEN + ["--metadata", "-", "--outdir", str(tmp_path),
                                        "--num_timesteps", "2", "--seed", "5"])
    assert gen_runner.run_gen(teng, tvae_tf, rows, str(tmp_path), args, rank=1, world=2) == [1]
    got = np.asarray(Image.open(tmp_path / "00001" / "samples" / "0000.png"))
    want = teng(text="prompt 1", image_shapes=(32, 32), num_timesteps=2, cfg_text_scale=2.0,
                cfg_img_scale=1.5, cfg_interval=(0.4, 1.0), timestep_shift=1.0,
                rng=torch.Generator().manual_seed(6))["image"]
    assert np.array_equal(got, want)


def test_cli_layouts_match_jax(tmp_path):
    """Both command lines on the micro weights write JAX's file layout:
    gen_runner the one that JAX's `main` wrote in test_run_gen_matches_jax
    (its metadata lines as JAX writes them), vlm_runner the results and
    scores files of JAX's `main` run here."""
    rows = _gen_rows(tmp_path)
    meta = tmp_path / "meta.jsonl"
    meta.write_text("\n".join(json.dumps({k: v for k, v in r.items() if k != "index"})
                              for r in rows))
    gen_runner.main(GEN + MICRO + ["--metadata", str(meta), "--image_root", str(tmp_path),
                                   "--num_timesteps", "2", "--outdir", str(tmp_path / "gen")])
    assert _layout(tmp_path / "gen") == [
        "00000/metadata.jsonl", "00000/samples/0000.png",
        "00001/metadata.jsonl", "00001/samples/0000.png"]
    for i, row in enumerate(rows):
        want = json.dumps({**{k: v for k, v in row.items() if k != "index"}, "index": i}) + "\n"
        assert (tmp_path / "gen" / f"{i:05d}" / "metadata.jsonl").read_text() == want
        img = np.asarray(Image.open(tmp_path / "gen" / f"{i:05d}" / "samples" / "0000.png"))
        assert img.shape == (32, 32, 3) and img.dtype == np.uint8

    vqa = _vqa_rows(tmp_path, 2, px=28)  # the micro tower's widest grid is 2 x 2
    data = tmp_path / "qa.jsonl"
    data.write_text("\n".join(json.dumps({k: v for k, v in r.items() if k != "index"})
                              for r in vqa))
    common = ["--max_kv", "512", "--data", str(data), "--image_root", str(tmp_path),
              "--max_length", "4", "--score", "yesno"]
    jvlm_runner.main(common + ["--out", str(tmp_path / "j.jsonl")])
    vlm_runner.main(common + ["--device", "cpu", "--out", str(tmp_path / "t.jsonl")])
    jrows = [json.loads(x) for x in (tmp_path / "j.jsonl").read_text().splitlines()]
    trows = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert [r["index"] for r in trows] == [0, 1, 2]
    jscores = json.loads((tmp_path / "j.jsonl.scores.json").read_text())
    tscores = json.loads((tmp_path / "t.jsonl.scores.json").read_text())
    assert sorted(tscores) == sorted(jscores)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_vlm_main_two_processes(tmp_path):
    """vlm_runner.main over two gloo processes (torchrun's environment):
    each rank answers rows[rank::2], rank 0 merges the rank files sorted by
    index, and the result equals the one-process run."""
    data = tmp_path / "qa.jsonl"
    data.write_text("\n".join(json.dumps({k: v for k, v in r.items() if k != "index"})
                              for r in _vqa_rows(tmp_path, 4, px=28)[:4]))
    common = MICRO + ["--data", str(data), "--image_root", str(tmp_path),
                      "--max_length", "4"]
    vlm_runner.main(common + ["--out", str(tmp_path / "one.jsonl")])

    code = ("import sys; from bagel_tpu_torch.eval import vlm_runner; "
            "vlm_runner.main(sys.argv[1:])")
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port, PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *common, "--out", str(tmp_path / "two.jsonl")],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    with reaped(procs):
        for p in procs:
            try:
                _, err = p.communicate(timeout=180)
            except subprocess.TimeoutExpired:
                pytest.fail("a rank hung")
            if p.returncode:
                errors.append(err)
    assert not errors, errors
    one = (tmp_path / "one.jsonl").read_text()
    assert (tmp_path / "two.jsonl").read_text() == one
    ranks = [[json.loads(x)["index"] for x in (tmp_path / f"two.jsonl.rank{r}").read_text()
              .splitlines()] for r in range(2)]
    assert ranks == [[0, 2], [1, 3]]
    assert [json.loads(x)["index"] for x in one.splitlines()] == [0, 1, 2, 3]
