"""The serving path of bagel_tpu_torch (CPU, fp32, tiny_bagel): the
continuous-batching runtime, the HTTP server and the app, against the
port's own single sessions and bagel_tpu's.

Bars: served answers identical to one session per request (and to
bagel_tpu's); slots reused; mixed chat and generate traffic; a session that
reaches the end of its KV rows ends with what it has (the decode margin,
speculative chunks included); an oversized request fails on its own future;
`stop` fails what is pending; multi-image requests; speculative chunks
greedy-exact; the int8 slot cache's answers equal bagel_tpu's; every
HTTP endpoint, streaming included; `app.build_engine` and
`run_once` on the CPU. Under a profiler session the runtime and the
engine leave their spans (runtime.admit over runtime.prefill,
runtime.decode, runtime.deliver; a denoise step each, one VAE decode),
and the engine module's `cfg_combine` stays the seam a recorder swaps.
"""

import base64
import http.client
import io
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_bagel
from bagel_tpu.data.tokenizer import MockTokenizer as JMockTokenizer
from bagel_tpu.inference.engine import BagelEngine as JEngine
from bagel_tpu.models import bagel as jbagel
from bagel_tpu_torch.data.tokenizer import MockTokenizer
from bagel_tpu_torch.data.transforms import ImageTransform, pil_img2rgb
from bagel_tpu_torch.inference.engine import BagelEngine
from bagel_tpu_torch.serving import app
from bagel_tpu_torch.serving.runtime import ServingRuntime
from bagel_tpu_torch.models.bagel import shifted_timesteps
from bagel_tpu_torch.serving.server import BagelServer, serve_in_thread
from bagel_tpu_torch.utils import trace
from bagel_tpu_torch.utils.bridge import params_from_numpy

from test_torch_qwen2 import randomized
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

TIMEOUT = 300


@pytest.fixture(scope="module")
def engines():
    cfg = tiny_bagel()
    tree = randomized(jbagel.init_bagel_params(jax.random.PRNGKey(0), cfg, jnp.float32), 11)
    tree["llm"]["lm_head"]["w"] = tree["llm"]["lm_head"]["w"] * 8.0  # no near ties
    jtok, ttok = JMockTokenizer(cfg.llm.vocab_size), MockTokenizer(cfg.llm.vocab_size)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, "cpu")

    def teng(**kw):
        return BagelEngine(tparams, cfg, ttok, ttok.new_token_ids, device="cpu",
                           **dict(dict(max_kv=512), **kw))

    def jeng(**kw):
        return JEngine(jparams, cfg, jtok, jtok.new_token_ids, **dict(dict(max_kv=512), **kw))

    return teng, jeng


@pytest.fixture(scope="module")
def engine(engines):
    return engines[0]()


def _image(rng, h, w):
    return (rng.standard_normal((h, w, 3)) * 0.3).astype(np.float32)


def _sequential(engine, images, prompt, max_new):
    ctx = engine.init_context()
    for im in [] if images is None else ([images] if isinstance(images, np.ndarray) else images):
        ctx = engine.update_context_image(im, ctx, vae=False, vit=True)
    ctx = engine.update_context_text(prompt, ctx)
    return engine.gen_text(ctx, max_length=max_new)


def _serve(rt, requests):
    rt.start()
    try:
        futs = [rt.submit_chat(p, image=im) for p, im in requests]
        return [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        rt.stop()


def test_runtime_chat_parity_and_slot_reuse(engines, engine):
    rng = np.random.default_rng(0)
    requests = [("what is this?", _image(rng, 28, 28)), ("just text", None),
                ("and this?", _image(rng, 28, 42))]
    # 3 requests on 2 slots: one retires and its slot is refilled
    rt = ServingRuntime(engine, slots=2, decode_chunk=3, max_new_default=6)
    got = _serve(rt, requests)
    assert rt.stats["chat_done"] == 3 and rt.stats["admitted"] == 3
    assert rt.stats["tokens_out"] == sum(len(g.split()) for g in got)
    jeng = engines[1]()
    for (p, im), g in zip(requests, got):
        assert g == _sequential(engine, im, p, 6)
        with jax.default_matmul_precision("float32"):
            assert g == _sequential(jeng, im, p, 6)


def test_runtime_counts_prefill_blocks_and_forwards(engine):
    rng = np.random.default_rng(1)
    rt = ServingRuntime(engine, slots=2, decode_chunk=4, max_new_default=4)
    rt.start()
    try:
        # admitted together: one image round and one text block
        futs = [rt.submit_chat("a", image=_image(rng, 28, 28)), rt.submit_chat("b")]
        got = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        rt.stop()
    assert rt.stats["prefill_blocks"] in (2, 3)  # 3 if the second came a tick late
    assert rt.stats["vit_passes"] == 1  # the image's admission, whichever group it joined
    steps = max(len(g.split()) for g in got)
    assert rt.stats["decode_forwards"] >= steps and rt.stats["chunks"] >= 1


def test_runtime_mixed_und_gen(engine):
    rt = ServingRuntime(engine, slots=2, decode_chunk=2, max_new_default=4)
    rt.start()
    try:
        chat = rt.submit_chat("hello")
        gen = rt.submit_generate("a thing", image_shapes=(32, 32), num_timesteps=3,
                                 cfg_text_scale=1.0, cfg_img_scale=1.0)
        ans = chat.result(timeout=TIMEOUT)
        out = gen.result(timeout=TIMEOUT)
    finally:
        rt.stop()
    assert isinstance(ans, str) and len(ans) > 0
    assert out["image"].shape == (32, 32, 3) and out["image"].dtype == np.uint8
    assert rt.stats["gen_done"] == 1


def test_runtime_gen_batch(engine):
    rt = ServingRuntime(engine, slots=1, gen_batch=2)
    kw = dict(image_shapes=(32, 32), num_timesteps=3, cfg_text_scale=1.0, cfg_img_scale=1.0)
    futs = [rt.submit_generate(p, **kw) for p in ("a red cube", "a blue ball")]
    rt._run_gen_jobs()  # both in one generate_batch
    assert rt.stats["gen_done"] == 2 and all(f.done() for f in futs)
    assert all(f.result()["image"].shape == (32, 32, 3) for f in futs)


@pytest.mark.parametrize("speculative", [0, 3])
def test_runtime_kv_exhaustion_finishes_session(engines, speculative):
    """A session whose next chunk could write past its KV rows (decode_chunk,
    plus draft_len + 1 for a speculative verify) ends with what it has; the
    scheduler keeps serving, and its slot's length is reset."""
    small = engines[0](max_kv=64)
    rt = ServingRuntime(small, slots=2, decode_chunk=16, max_new_default=10_000,
                        speculative=speculative, ngram=2)
    rt.start()
    try:
        ans = rt.submit_chat("fill the buffer please").result(timeout=TIMEOUT)
        second = rt.submit_chat("second request").result(timeout=TIMEOUT)
    finally:
        rt.stop()
    assert isinstance(ans, str) and isinstance(second, str)
    assert rt.stats["chat_done"] == 2
    margin = 16 + (speculative + 1 if speculative else 0)
    prompt = len("fill the buffer please") + 2
    cap = small.max_kv  # 64 rounds up to the 256 of kv_bucket
    # the session ran its chunks while its length plus the margin fitted
    assert prompt + len(ans.split()) + margin > cap
    assert prompt + len(ans.split()) - 16 + margin <= cap


def test_runtime_decode_margin_checked_before_each_chunk(engine):
    """The margin check alone: a live row whose length + decode_chunk +
    draft_len + 1 passes max_kv is retired before the chunk runs."""
    rt = ServingRuntime(engine, slots=1, decode_chunk=8, speculative=4)
    fut = rt.submit_chat("hi")
    rt._admit()
    n = engine.max_kv - 8 - 4  # one short of the margin: the chunk must not run
    length = rt.cache.length.clone()
    length[0] = n
    rt.cache.length = length
    rt._decode_step()
    assert fut.done() and fut.result() == "" and rt.stats["chunks"] == 0
    assert int(rt.cache.length[0]) == 0 and rt.slot_state[0] is None


def test_runtime_defers_admission_near_a_full_live_row(engine):
    rt = ServingRuntime(engine, slots=2, decode_chunk=2, max_new_default=4)
    t0 = time.perf_counter()
    first = rt.submit_chat("live session")
    rt._admit()
    t1 = time.perf_counter()
    assert rt.stats["admitted"] == 1 and 0 < rt.stats["queue_wait_s"] < t1 - t0
    length = rt.cache.length.clone()
    length[0] = engine.max_kv - 8  # the next padded prefill block would not fit
    rt.cache.length = length
    waiting = rt.submit_chat("waits")
    t2 = time.perf_counter()
    rt._admit()
    assert rt.slot_state[1] is None and rt.chat_q.qsize() == 1 and not waiting.done()
    assert not first.done()
    assert rt.stats["requeued"] == 1 and rt.stats["admitted"] == 1
    # the live row retires: the waiting request is admitted, its wait counted
    rt._retire(0)
    t3 = time.perf_counter()
    rt._admit()
    t4 = time.perf_counter()
    assert rt.slot_state[0].req.future is waiting and rt.chat_q.qsize() == 0
    assert rt.stats["admitted"] == 2 and rt.stats["requeued"] == 1
    assert t3 - t2 < rt.stats["queue_wait_s"] < (t1 - t0) + (t4 - t2)


def test_runtime_spans_under_a_profiler(engine):
    rt = ServingRuntime(engine, slots=2, decode_chunk=2, max_new_default=4)
    rt.start()
    thread = rt._thread.ident
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            ans = rt.submit_chat("traced").result(timeout=TIMEOUT)
    finally:
        rt.stop()
    got = trace.spans(t0)
    by = {}
    for s in got:
        by.setdefault(s["name"], []).append(s)
    assert {"runtime.admit", "runtime.prefill", "runtime.decode", "runtime.deliver"} <= set(by)
    assert all(s["thread"] == thread for s in got)
    (pre,) = by["runtime.prefill"]
    (adm,) = [s for s in by["runtime.admit"] if s["id"] == pre["parent"]]
    assert adm["t0"] <= pre["t0"] < pre["t1"] <= adm["t1"] and adm["parent"] is None
    chunks = -(-len(ans.split()) // 2)  # 2-step chunks, up to 4 tokens
    assert len(by["runtime.decode"]) >= chunks and len(by["runtime.deliver"]) >= chunks
    assert all(s["parent"] is None for s in by["runtime.decode"] + by["runtime.deliver"])
    assert all(s["device_ms"] is None for s in got)  # no device time on the CPU
    assert rt.stats["admitted"] == 1 and rt.stats["requeued"] == 0


class _CombineRecorder:
    """Wraps the engine module's `cfg_combine`, as the benchmark's t2i
    check does: one call per job and denoise step."""

    def __init__(self, module):
        self.module, self.orig, self.calls = module, module.cfg_combine, 0
        module.cfg_combine = self

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.orig(*args, **kw)


@pytest.mark.parametrize("taylorseer", [False, True])
def test_gen_image_spans_and_the_cfg_combine_seam(engine, monkeypatch, taylorseer):
    from bagel_tpu_torch.inference import engine as engine_mod

    n = 8 if taylorseer else 5
    monkeypatch.setattr(engine_mod, "cfg_combine", engine_mod.cfg_combine)
    rec = _CombineRecorder(engine_mod)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        out = engine(text="a red cube", image_shapes=(32, 32), num_timesteps=n,
                     cfg_interval=(0.5, 1.0), enable_taylorseer=taylorseer,
                     taylorseer_first_enhance=2, taylorseer_threshold=2)
    assert out["image"].shape == (32, 32, 3)
    ts, _ = shifted_timesteps(n, 3.0)
    steps = [s for s in trace.spans(t0) if s["name"] == "engine.denoise_step"]
    vae = [s for s in trace.spans(t0) if s["name"] == "engine.vae_decode"]
    assert len(steps) == len(ts) == rec.calls and len(vae) == 1
    on = (ts > 0.5) & (ts <= 1.0)
    assert 0 < on.sum() < len(ts)
    assert [s["attrs"]["rows"] for s in steps] == [3 if o else 1 for o in on]
    if taylorseer:
        full = [s["attrs"]["full"] for s in steps]
        assert 0 < sum(full) < len(full)
    else:
        assert all("full" not in s["attrs"] for s in steps)
    assert vae[0]["t0"] >= steps[-1]["t1"]


def test_runtime_oversized_request_fails_cleanly(engines):
    small = engines[0](max_kv=32)
    rt = ServingRuntime(small, slots=1, decode_chunk=2, max_new_default=4)
    rt.start()
    try:
        bad = rt.submit_chat("x" * 500)  # far past the 32-token buffer
        with pytest.raises(ValueError, match="raise max_kv"):
            bad.result(timeout=TIMEOUT)
        assert isinstance(rt.submit_chat("hi").result(timeout=TIMEOUT), str)
    finally:
        rt.stop()


def test_runtime_stop_fails_pending(engine):
    rt = ServingRuntime(engine, slots=1, decode_chunk=2, max_new_default=4)
    fut = rt.submit_chat("will never run")
    gen = rt.submit_generate("nor this", image_shapes=(32, 32), num_timesteps=2)
    rt._stop.set()  # stopped before its first tick: the loop only drains
    rt.start()
    rt.stop()
    for f in (fut, gen):
        with pytest.raises(RuntimeError, match="stopped"):
            f.result(timeout=5)


def test_runtime_multi_image_request(engine):
    rng = np.random.default_rng(5)
    imgs = [_image(rng, 28, 28), _image(rng, 28, 42)]
    rt = ServingRuntime(engine, slots=2, decode_chunk=3, max_new_default=6)
    got = _serve(rt, [("compare these", imgs)])[0]
    assert got == _sequential(engine, imgs, "compare these", 6)
    # both images in one packed SigLIP pass, one image round each
    assert rt.stats["vit_passes"] == 1 and rt.stats["prefill_blocks"] == 3


def test_runtime_speculative_parity(engine):
    rng = np.random.default_rng(7)
    requests = [("repeat repeat repeat the repeat pattern repeat", None),
                ("what is shown here? what is shown?", _image(rng, 28, 28)),
                ("the quick brown fox and the quick brown fox", None)]

    def run(spec):
        rt = ServingRuntime(engine, slots=2, decode_chunk=4, max_new_default=8,
                            speculative=spec, ngram=2)
        return _serve(rt, requests), rt.stats

    (plain, plain_stats), (spec, spec_stats) = run(0), run(3)
    assert spec == plain
    assert spec_stats["tokens_out"] == plain_stats["tokens_out"]


def test_exclusive_jobs_inherit_runtime_speculative(engine):
    """Jobs on the exclusive queue (think, understanding) take the runtime's
    speculative K unless the request set its own."""
    rt = ServingRuntime(engine, slots=2, speculative=5)
    seen = []
    rt.engine = lambda **kw: seen.append(kw) or {"text": "ok"}
    rt.submit_generate("q", understanding_output=True)
    rt.submit_generate("q", understanding_output=True, speculative=0)
    rt._run_gen_jobs()
    rt._run_gen_jobs()
    assert [kw["speculative"] for kw in seen] == [5, 0]


def test_runtime_kv_quant_matches_jax(engines):
    rng = np.random.default_rng(3)
    requests = [("what is this?", _image(rng, 28, 28)), ("just text", None)]
    teng = engines[0](kv_quant=True)
    rt = ServingRuntime(teng, slots=2, decode_chunk=3, max_new_default=6)
    assert rt.cache.k.dtype == torch.int8 and rt.cache.k_scale is not None
    got = _serve(rt, requests)
    jeng = engines[1](kv_quant=True)
    with jax.default_matmul_precision("float32"):
        want = jeng.chat_batch([im for _, im in requests], [p for p, _ in requests],
                               max_length=6)
    assert got == want
    assert got == teng.chat_batch([im for _, im in requests], [p for p, _ in requests],
                                  max_length=6)


def test_runtime_survives_a_failing_decode(engine, monkeypatch):
    """A decode chunk that raises fails the live sessions, rebuilds the
    cache and keeps the scheduler serving."""
    from bagel_tpu_torch.serving import runtime as rmod

    rt = ServingRuntime(engine, slots=2, decode_chunk=2, max_new_default=4)
    real = rmod.qwen2.decode_text
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("kernel launch failed")
        return real(*a, **kw)

    monkeypatch.setattr(rmod.qwen2, "decode_text", flaky)
    rt.start()
    try:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            rt.submit_chat("first").result(timeout=TIMEOUT)
        assert isinstance(rt.submit_chat("second").result(timeout=TIMEOUT), str)
    finally:
        rt.stop()


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stack(engine):
    cfg = engine.cfg
    rt = ServingRuntime(engine, slots=2, decode_chunk=3, max_new_default=6)
    rt.start()
    vae_tf = ImageTransform(64, 16, cfg.latent_downsample, max_pixels=64 * 64)
    vit_tf = ImageTransform(56, 28, cfg.vit.patch_size, max_pixels=56 * 56)
    httpd, thread = serve_in_thread(BagelServer(rt, vae_tf, vit_tf))
    host, port = httpd.server_address
    yield engine, rt, host, port, vit_tf
    httpd.shutdown()
    httpd.server_close()
    rt.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _request(host, port, method, path, body=None):
    conn = http.client.HTTPConnection(host, port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=json.dumps(body) if body is not None else None,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _png_b64(arr: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def test_healthz_and_stats(stack):
    _, _, host, port, _ = stack
    assert _request(host, port, "GET", "/healthz") == (200, {"ok": True})
    status, body = _request(host, port, "GET", "/v1/stats")
    assert status == 200 and body["slots"] == 2
    assert {"tokens_out", "chat_done", "decode_forwards", "prefill_blocks"} <= set(body)


def test_chat_parity_with_direct_submit(stack):
    _, rt, host, port, _ = stack
    status, body = _request(host, port, "POST", "/v1/chat",
                            {"prompt": "what is this?", "max_tokens": 5})
    assert status == 200
    assert body["text"] == rt.submit_chat("what is this?", max_new_tokens=5).result(TIMEOUT)
    assert len(body["text"].split()) <= 5


def test_chat_with_images(stack):
    engine, _, host, port, vit_tf = stack
    from PIL import Image

    rng = np.random.default_rng(1)
    raw = [(rng.random((40, 40, 3)) * 255).astype(np.uint8) for _ in range(2)]
    status, one = _request(host, port, "POST", "/v1/chat",
                           {"prompt": "describe", "image": _png_b64(raw[0]), "max_tokens": 4})
    assert status == 200 and isinstance(one["text"], str)
    status, two = _request(host, port, "POST", "/v1/chat",
                           {"prompt": "compare these", "images": [_png_b64(x) for x in raw],
                            "max_tokens": 5})
    assert status == 200
    imgs = [vit_tf(pil_img2rgb(Image.fromarray(x))) for x in raw]
    assert two["text"] == engine.chat_batch([imgs], ["compare these"], max_length=5)[0]


def test_generate_and_edit_return_png(stack):
    from PIL import Image

    _, rt, host, port, _ = stack
    before = rt.stats["gen_done"]
    body = {"prompt": "a thing", "image_size": 32, "num_timesteps": 3,
            "cfg_text_scale": 1.0, "cfg_img_scale": 1.0, "seed": 3}
    status, out = _request(host, port, "POST", "/v1/generate", body)
    assert status == 200 and out["shape"] == [32, 32]
    img = Image.open(io.BytesIO(base64.b64decode(out["image"])))
    assert img.size == (32, 32)
    assert _request(host, port, "POST", "/v1/generate", body)[1]["image"] == out["image"]
    src = (np.random.default_rng(2).random((32, 32, 3)) * 255).astype(np.uint8)
    status, edit = _request(host, port, "POST", "/v1/generate",
                            {"prompt": "make it blue", "image": _png_b64(src),
                             "num_timesteps": 3, "seed": 0})
    assert status == 200 and edit["shape"] == [32, 32]
    assert rt.stats["gen_done"] == before + 3


def test_error_paths(stack):
    _, _, host, port, _ = stack
    status, body = _request(host, port, "POST", "/v1/chat", {})
    assert status == 400 and "prompt" in body["error"]
    assert _request(host, port, "GET", "/nope")[0] == 404
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("POST", "/v1/chat", body="{not json",
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 400
        resp.read()
    finally:
        conn.close()


def test_concurrent_chats_share_batch(stack):
    _, rt, host, port, _ = stack
    before = rt.stats["chat_done"]
    results = {}

    def go(i):
        results[i] = _request(host, port, "POST", "/v1/chat",
                              {"prompt": f"q{i}", "max_tokens": 4})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    assert all(results[i][0] == 200 for i in range(3))
    assert rt.stats["chat_done"] >= before + 3


def test_chat_think_mode(stack):
    _, _, host, port, _ = stack
    status, body = _request(host, port, "POST", "/v1/chat",
                            {"prompt": "why?", "think": True, "max_tokens": 8})
    assert status == 200 and isinstance(body["text"], str)


def test_chat_streaming(stack):
    _, rt, host, port, _ = stack
    conn = http.client.HTTPConnection(host, port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/v1/chat",
                     body=json.dumps({"prompt": "stream me", "max_tokens": 6, "stream": True}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "application/x-ndjson"
        events = [json.loads(line) for line in resp.read().splitlines() if line.strip()]
    finally:
        conn.close()
    assert events[-1].get("done") is True
    deltas = [e["text_delta"] for e in events[:-1]]
    assert len(deltas) >= 2  # decode_chunk 3, 6 tokens: two chunks at least
    assert "".join(deltas) == events[-1]["text"]
    assert events[-1]["text"] == rt.submit_chat("stream me", max_new_tokens=6).result(TIMEOUT)


def test_chat_streaming_missing_prompt_is_400(stack):
    _, _, host, port, _ = stack
    status, body = _request(host, port, "POST", "/v1/chat", {"stream": True})
    assert status == 400 and "prompt" in body["error"]


# ---------------------------------------------------------------------------
# app
# ---------------------------------------------------------------------------


def test_app_build_engine_and_run_once(tmp_path, capsys):
    # understand decodes up to 1000 tokens (interleave_inference's default)
    args = app.parse_args(["--device", "cpu", "--max_kv", "2048", "--kv_quant"])
    engine, vae_tf, vit_tf = app.build_engine(args)
    assert engine.device.type == "cpu" and engine.kv_dtype == torch.int8
    assert "qkv" in engine.params["llm"]["layers"]["attn"]  # fused by default
    out = app.run_once(engine, vae_tf, vit_tf, app.parse_args(
        ["--mode", "understand", "--prompt", "hello", "--device", "cpu"]))
    assert out["text"] is not None
    png = tmp_path / "out.png"
    out = app.run_once(engine, vae_tf, vit_tf, app.parse_args(
        ["--mode", "t2i", "--prompt", "a cat", "--image_size", "32", "--num_timesteps", "2",
         "--output", str(png), "--device", "cpu"]))
    assert out["image"].shape == (32, 32, 3) and png.is_file()
    assert "saved" in capsys.readouterr().out
