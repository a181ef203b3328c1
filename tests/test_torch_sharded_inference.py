"""Sharded inference on the port vs bagel_tpu's unsharded engine (the port's
counterparts of tests/test_sharded_inference.py and
test_serving_runtime.py:131,207), tiny_bagel (4 query heads over 2 KV heads)
in fp32 on the CPU, over gloo processes (tests/torch_dist_util.py): one
world of 2 processes for the meshes (1, 1, 2), (1, 2, 1), (2, 1, 1), one of
4 for (1, 2, 2) and (1, 1, 4) (tp above the KV heads: each rank keeps the KV
head its query head reads).

Each process places the numpy tree leaf by leaf (`params_from_numpy(
layout=)`; the quantized trees quantized on the whole leaf by JAX first)
and fuses its shards. Per mesh:
- text-to-image (a randomized `llm2vae`, JAX's noise handed over): the fp32
  latent within 1e-4 of JAX's; w8a8 and int8 weights make both engines bf16
  (a quantized embedding), held to test_torch_quant_engine.py's bf16 bound;
  at tp > 1 the w8a8 latent also within W8A8_TP_TOL of the unsharded
  port's on the same weights and noise;
- understanding: the greedy answer identical;
- the serving runtime over the sharded slot cache (2 slots, over dp where
  dp = 2), plain and speculative=2: every answer identical to JAX's
  request alone;
- every rank returns the same latents and answers, bit for bit;
- the slot cache's local part follows JAX's `_shard_cache` rule.
In the (1, 1, 2) world, a row-parallel w8a8 linear at tiny_bagel's `o` and
`down` shapes (bf16 rows whose two halves differ in magnitude): each
rank's codes and scales equal its slice of JAX's whole-row quantization
bit for bit, the all-reduced output is within one bf16 ulp of JAX's
`_linear`, and the control (each slice quantized with its own scale) is
not. Then the shapes the layout refuses, the runtime's and the app's mesh
checks, and vlm_runner under --mesh 1,1,2 over two processes.
"""

import json
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_bagel
from bagel_tpu.data.tokenizer import MockTokenizer as JMockTokenizer
from bagel_tpu.inference.engine import BagelEngine as JEngine
from bagel_tpu.models import bagel as jbagel
from bagel_tpu.models import qwen2 as jq
from bagel_tpu.utils import quant as jquant
from bagel_tpu_torch.configs import tiny_bagel as ttiny_bagel
from bagel_tpu_torch.configs import tiny_qwen2
from bagel_tpu_torch.data.tokenizer import MockTokenizer
from bagel_tpu_torch.eval.gen_runner import row_shard
from bagel_tpu_torch.inference.engine import BagelEngine
from bagel_tpu_torch.models.bagel import init_bagel_params
from bagel_tpu_torch.models.qwen2 import fuse_llm_params
from bagel_tpu_torch.parallel.mesh import AXES, InferenceLayout, make_mesh
from bagel_tpu_torch.serving import app
from bagel_tpu_torch.serving.runtime import ServingRuntime
from bagel_tpu_torch.utils.bridge import params_from_numpy

from asserts import assert_close_live, assert_latent_motion
from test_torch_qwen2 import randomized
from test_torch_quant_engine import LATENT_TOL, _bf16_rest
from test_torch_w8a8_kmajor import _jax_quantize_rows
from torch_dist_util import REPO, run

WORLD2 = [(1, 1, 2), (1, 2, 1), (2, 1, 1)]
WORLD4 = [(1, 2, 2), (1, 1, 4)]
SHAPES = WORLD2 + WORLD4
QUANT = ("w8a8", "int8")
MAX_NEW = 6
DEADLINE = 280
# the sharded w8a8 latent against the unsharded port's: equal at every tp > 1
# mesh here; the bound leaves room for the partial sums' fp32 order to flip
# a bf16 rounding. With each rank's own scale (before each row took its
# whole row's) they were 0.0095 apart at tp = 2 and 0.0058 at tp = 4.
W8A8_TP_TOL = 2e-3


def _image(rng, px):
    return (rng.standard_normal((px, px, 3)) * 0.3).astype(np.float32)


def _work(cfg, seed, steps):
    rng = np.random.default_rng(seed)
    n = (32 // cfg.latent_downsample) ** 2
    return dict(
        prompt="a red cube", shape=(32, 32),
        noise=rng.standard_normal((n, cfg.patch_latent_dim)).astype(np.float32),
        gen=dict(num_timesteps=steps, timestep_shift=3.0, cfg_text_scale=4.0, cfg_img_scale=1.5),
        image=_image(rng, 28), question="what is this?", max_new=MAX_NEW,
    )


CHATS = [("what is this?", _image(np.random.default_rng(4), 28)), ("just text", None),
         ("a third one", None)]


def _port_latent(job):
    """The unsharded port's text-to-image latent of a job."""
    cfg, work = job["cfg"], job["work"]
    tok = MockTokenizer(cfg.llm.vocab_size)
    params = params_from_numpy(job["tree"], "cpu")
    params["llm"] = fuse_llm_params(params["llm"], inplace=True)
    eng = BagelEngine(params, cfg, tok, tok.new_token_ids, max_kv=512, device="cpu")
    ctx = eng.init_context()
    cfg_text, cfg_img = ctx.copy(), ctx.copy()
    ctx = eng.update_context_text(work["prompt"], ctx)
    cfg_img = eng.update_context_text(work["prompt"], cfg_img)
    return eng.gen_image(work["shape"], ctx, cfg_text_precontext=cfg_text,
                         cfg_img_precontext=cfg_img, init_noise=work["noise"],
                         return_latent=True, **work["gen"])


def _linear_cases(cfg):
    """Row-parallel w8a8 linears at cfg's o and down shapes: bf16 rows whose
    two tp halves differ in magnitude (as heads and FFN columns do), random
    codes and column scales."""
    rng = np.random.default_rng(11)
    d, f = cfg.llm.hidden_size, cfg.llm.intermediate_size
    cases = []
    for name, k in (("o", cfg.llm.num_attention_heads * cfg.llm.head_dim), ("down", f)):
        mag = rng.uniform(0.05, 4.0, (6, 2)).repeat(k // 2, axis=1)
        x = torch.tensor(rng.standard_normal((6, k)) * mag).bfloat16().float().numpy()
        cases.append(dict(name=name, x=x, w_q8=rng.integers(-127, 128, (k, d)).astype(np.int8),
                          scale=(rng.uniform(0.5, 2.0, d) * 0.02 / 127).astype(np.float32)))
    return cases


def _jax_linear(case):
    """JAX's w8a8 `_linear` of a case (bf16 out) and its whole-row codes and
    scales."""
    x = jnp.asarray(case["x"], jnp.bfloat16)
    out = jq._linear(x, {"w_q8": jnp.asarray(case["w_q8"]), "scale": jnp.asarray(case["scale"])})
    codes, scales = _jax_quantize_rows(x)
    return dict(out=np.asarray(out, np.float32), codes=codes, scale=scales)


def _jax_job(job):
    """The unsharded JAX engine's results of a `sharded_paths` job."""
    cfg, work = job["cfg"], job["work"]
    tok = JMockTokenizer(cfg.llm.vocab_size)
    params = jax.tree.map(jnp.asarray, job["tree"])
    params["llm"] = jq.fuse_llm_params(params["llm"])
    eng = JEngine(params, cfg, tok, tok.new_token_ids, max_kv=512)
    ctx = eng.init_context()
    cfg_text, cfg_img = ctx.copy(), ctx.copy()
    ctx = eng.update_context_text(work["prompt"], ctx)
    cfg_img = eng.update_context_text(work["prompt"], cfg_img)
    out = dict(latent=np.asarray(eng.gen_image(
        work["shape"], ctx, cfg_text_precontext=cfg_text, cfg_img_precontext=cfg_img,
        init_noise=work["noise"], return_latent=True, **work["gen"]), np.float32))
    if job.get("chats"):
        out["understand"] = eng(image=work["image"], text=work["question"],
                                understanding_output=True, max_think_token_n=MAX_NEW)["text"]
        answers = []
        for prompt, image in job["chats"]:
            c = eng.init_context()
            if image is not None:
                c = eng.update_context_image(image, c, vae=False, vit=True)
            answers.append(eng.gen_text(eng.update_context_text(prompt, c), max_length=MAX_NEW))
        out["serve"] = answers
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = tiny_bagel()
    tree = jax.tree.map(np.asarray, jbagel.init_bagel_params(jax.random.PRNGKey(0), cfg,
                                                             jnp.float32))
    tree["llm"]["lm_head"]["w"] = tree["llm"]["lm_head"]["w"] * 8.0  # no near ties
    # a zero llm2vae freezes the flow (the comparison would be noise to noise)
    tree["llm2vae"]["w"] = (0.1 * np.random.default_rng(7).standard_normal(
        tree["llm2vae"]["w"].shape)).astype(np.float32)
    jobs = [dict(name="fp32", cfg=cfg, tree=tree, work=_work(cfg, 3, 4), chats=CHATS)]
    # the quantized engines at test_torch_quant_engine.py's text-to-image
    # (its weights, noise and schedule), where its bf16 bound was measured;
    # each leaf quantized whole by JAX, then cut by each process
    qcfg = tiny_bagel(visual_und=False)
    qtree = _bf16_rest(randomized(jbagel.init_bagel_params(jax.random.PRNGKey(0), qcfg,
                                                           jnp.float32), 7))
    qwork = _work(qcfg, 8, 8)
    for kind in QUANT:
        jobs.append(dict(name=kind, cfg=qcfg, work=qwork, tree=jax.tree.map(
            np.asarray, jquant.quantize_bagel_params(jax.tree.map(jnp.asarray, qtree), kind))))
    linears = _linear_cases(qcfg)
    with jax.default_matmul_precision("float32"):
        want = {job["name"]: _jax_job(job) for job in jobs}
        want["linears"] = [_jax_linear(c) for c in linears]
    want["w8a8"]["port_latent"] = _port_latent(jobs[1])
    tmp = tmp_path_factory.mktemp("sharded")
    got = {}
    for world, shapes in ((2, WORLD2), (4, WORLD4)):
        ranks = run("sharded_paths", world, tmp, deadline=DEADLINE, shapes=shapes, jobs=jobs,
                    linears=linears if world == 2 else ())
        for shape in shapes:
            got[shape] = [r[shape] for r in ranks]
    return {job["name"]: job["work"] for job in jobs}, want, got


def _same_on_every_rank(per_rank, job, key):
    first = per_rank[0][job][key]
    for r, res in enumerate(per_rank[1:], 1):
        if isinstance(first, np.ndarray):
            assert np.array_equal(res[job][key], first), f"rank {r}'s {key} differs from rank 0's"
        else:
            assert res[job][key] == first, f"rank {r}'s {key} differs from rank 0's"
    return first


@pytest.mark.parametrize("shape", SHAPES)
def test_text_to_image_matches_jax(runs, shape):
    works, want, got = runs
    latent = _same_on_every_rank(got[shape], "fp32", "latent")
    assert_latent_motion(want["fp32"]["latent"], works["fp32"]["noise"])
    assert_close_live(latent, want["fp32"]["latent"], moved_from=works["fp32"]["noise"],
                      rtol=1e-4, atol=1e-4, name="latent")


@pytest.mark.parametrize("kind", QUANT)
@pytest.mark.parametrize("shape", SHAPES)
def test_quantized_text_to_image_matches_jax(runs, shape, kind):
    works, want, got = runs
    latent = _same_on_every_rank(got[shape], kind, "latent")
    assert np.isfinite(latent).all()
    assert_close_live(latent, want[kind]["latent"], moved_from=works[kind]["noise"], floor=0.1,
                      rtol=0, atol=LATENT_TOL, name="latent")
    if kind == "w8a8" and shape[2] > 1:  # each row quantized with its whole row's scale
        gap = float(np.abs(latent - want[kind]["port_latent"]).max())
        assert gap <= W8A8_TP_TOL, (gap, W8A8_TP_TOL)


def _bf16_ulp(x):
    """One bf16 ulp of each value (of the smallest normal near 0)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("leaf", [0, 1], ids=["o", "down"])
def test_row_parallel_w8a8_linear_matches_jax(runs, leaf):
    _, want, got = runs
    ref = want["linears"][leaf]
    per_rank = [r["linears"][leaf] for r in got[(1, 1, 2)]]
    for r, res in enumerate(per_rank):
        assert np.array_equal(res["codes"], np.split(ref["codes"], 2, axis=-1)[r]), r
        assert np.array_equal(res["scale"], ref["scale"]), r
        assert np.array_equal(res["out"], per_rank[0]["out"]), r
    ulp = _bf16_ulp(ref["out"])
    err = np.abs(per_rank[0]["out"] - ref["out"])
    assert (err <= ulp).all(), float((err / ulp).max())
    # the control, each slice with its own scale, parts from JAX by more
    assert not (np.abs(per_rank[0]["control"] - ref["out"]) <= ulp).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_understanding_matches_jax(runs, shape):
    _, want, got = runs
    answer = _same_on_every_rank(got[shape], "fp32", "understand")
    assert answer and answer == want["fp32"]["understand"]


@pytest.mark.parametrize("spec", [0, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_runtime_matches_jax(runs, shape, spec):
    _, want, got = runs
    answers = _same_on_every_rank(got[shape], "fp32", f"serve_{spec}")
    assert answers == want["fp32"]["serve"]


@pytest.mark.parametrize("shape", SHAPES)
def test_slot_cache_follows_jax_rule(runs, shape):
    """JAX shards the slots over dp where dp divides them and the KV heads
    over tp where tp divides them; above the KV heads each rank keeps the
    one its query heads read."""
    _, _, got = runs
    dp, _, tp = shape
    kh = tiny_qwen2().num_key_value_heads
    for r, res in enumerate(got[shape]):
        c = res["fp32"]["cache"]
        rows = 2 // dp
        dpi, tpi = np.unravel_index(r, shape)[0], np.unravel_index(r, shape)[2]
        assert c["rows"] == (dpi * rows, rows) and c["kv_heads"] == max(kh // tp, 1)
        assert c["local"][1:4:2] == (rows, c["kv_heads"]) == c["shard"][1:4:2]
        head = tpi * kh // tp if kh >= tp else tpi // (tp // kh)
        want = c["whole_k"][:, dpi * rows:(dpi + 1) * rows, :, head:head + c["kv_heads"]]
        assert np.array_equal(c["shard_k"], want)


def _stub_mesh(dp, fsdp, tp):
    shape = dict(zip(AXES, (dp, fsdp, tp)))
    return types.SimpleNamespace(axes=AXES, shape=shape, coord=dict.fromkeys(AXES, 0),
                                 world=dp * fsdp * tp, group=lambda *a: None)


@pytest.mark.parametrize("llm, shape, match", [
    (dict(), (1, 1, 3), "axis tp = 3 does not divide the LLM's 4 query heads"),
    (dict(intermediate_size=130), (1, 1, 4), "axis tp = 4 does not divide the LLM's 130 FFN"),
    (dict(num_attention_heads=6, hidden_size=96, num_key_value_heads=3), (1, 1, 2),
     "axis tp = 2 neither divides the LLM's 3 KV heads"),
])
def test_refused_shapes(llm, shape, match):
    cfg = ttiny_bagel(llm=tiny_qwen2(**llm))
    with pytest.raises(ValueError, match=match):
        InferenceLayout(_stub_mesh(*shape), cfg)


def test_refused_leaves():
    """A 4-bit leaf split along its input rows splits on its scale groups,
    and a leaf split over an axis splits evenly: else the axis is named."""
    layout = InferenceLayout(_stub_mesh(1, 1, 2), ttiny_bagel())
    # o's 64 input rows are one int4 group of 64 at this width
    with pytest.raises(ValueError, match="llm/layers/attn/o/scale4 over axis tp"):
        layout.place("llm/layers/attn/o/scale4", torch.ones(2, 1, 64))
    layout = InferenceLayout(_stub_mesh(1, 4, 1), ttiny_bagel())
    with pytest.raises(ValueError, match="vit/patch_embed/w over axis fsdp"):
        layout.place("vit/patch_embed/w", torch.ones(588, 6))


def test_runtime_takes_the_engines_mesh():
    """A mesh other than the engine's is refused; the engine's shards the
    cache."""
    cfg = ttiny_bagel()
    tok = MockTokenizer(cfg.llm.vocab_size)
    layout = InferenceLayout(make_mesh((1, 1, 1)), cfg)
    params = init_bagel_params(torch.Generator().manual_seed(0), cfg, torch.float32,
                               device="cpu", place=layout.place)
    eng = BagelEngine(params, cfg, tok, tok.new_token_ids, max_kv=256, device="cpu",
                      layout=layout)
    with pytest.raises(ValueError, match="the engine's own mesh"):
        ServingRuntime(eng, slots=2, mesh=make_mesh((1, 1, 1)))
    rt = ServingRuntime(eng, slots=2, mesh=eng.mesh)
    assert rt.cache.k.shape[1] == 2 and (rt.first, rt.count) == (0, 2)


def test_app_mesh_checks_the_world():
    """The shape's product must be the number of processes; --mesh 1,1,1 in
    one process runs the layout's path, with the plain engine's answer."""
    with pytest.raises(ValueError, match="needs 8 processes"):
        app.build_engine(app.parse_args(["--device", "cpu", "--mesh", "1,8,1"]))
    with pytest.raises(ValueError, match="--mesh takes dp,fsdp,tp"):
        app.build_engine(app.parse_args(["--device", "cpu", "--mesh", "2,1"]))
    argv = ["--device", "cpu", "--max_kv", "512"]
    sharded, _, _ = app.build_engine(app.parse_args(argv + ["--mesh", "1,1,1"]))
    plain, _, _ = app.build_engine(app.parse_args(argv))
    assert sharded.mesh is not None and sharded.mesh.shape == dict(dp=1, fsdp=1, tp=1)
    kw = dict(image=_image(np.random.default_rng(0), 28), text="what?", understanding_output=True, max_think_token_n=4)
    assert sharded(**kw)["text"] == plain(**kw)["text"]


def test_row_shard_over_dp():
    eng = types.SimpleNamespace(mesh=None)
    assert row_shard(eng, 3, 4) == (3, 4, True)
    mesh = types.SimpleNamespace(shape=dict(dp=2, fsdp=1, tp=2), coord=dict(dp=1, fsdp=0, tp=1))
    assert row_shard(types.SimpleNamespace(mesh=mesh), 3, 4) == (1, 2, False)
    mesh.coord["tp"] = 0
    assert row_shard(types.SimpleNamespace(mesh=mesh), 2, 4) == (1, 2, True)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_vlm_main_over_a_tp_mesh(tmp_path):
    """vlm_runner.main --mesh 1,1,2 over two gloo processes (torchrun's
    environment): both ranks run every row through the sharded engine, rank
    0 writes, and the results equal one process's run without a mesh."""
    from PIL import Image

    from bagel_tpu_torch.eval import vlm_runner

    rng = np.random.default_rng(0)
    rows = []
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (28, 28, 3), dtype=np.uint8)).save(
            tmp_path / f"{i}.png")
        rows.append({"image": f"{i}.png", "question": f"is it {i}?", "answer": "yes"})
    data = tmp_path / "qa.jsonl"
    data.write_text("\n".join(json.dumps(r) for r in rows))
    common = ["--device", "cpu", "--max_kv", "512", "--data", str(data), "--image_root",
              str(tmp_path), "--max_length", "4"]
    vlm_runner.main(common + ["--out", str(tmp_path / "one.jsonl")])
    code = "import sys; from bagel_tpu_torch.eval import vlm_runner; vlm_runner.main(sys.argv[1:])"
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *common, "--mesh", "1,1,2", "--out", str(tmp_path / "tp.jsonl")],
        cwd=REPO, env=dict(os.environ, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=port, PYTHONPATH=REPO,
                           OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    errors = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=DEADLINE)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a rank hung")
        if p.returncode:
            errors.append(err[-3000:])
    assert not errors, errors
    assert (tmp_path / "tp.jsonl").read_text() == (tmp_path / "one.jsonl").read_text()
    assert not list(tmp_path.glob("tp.jsonl.rank*"))
