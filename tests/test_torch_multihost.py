"""bagel_tpu_torch.serving.multihost vs bagel_tpu's
(tests/test_multihost_serving.py:42,84, test_multihost_distributed.py:72),
tiny_bagel in fp32 on the CPU:

- a leader and a follower over a `LocalBus` in one process: the follower
  replays the leader's schedule from the broadcast ingress alone (equal
  stats and tick counts; the summed queue wait, on each process's own
  clock, is only positive on both), the leader's greedy answers equal one session per
  request and bagel_tpu's, a generate job runs between chats, and a
  follower refuses client traffic;
- one process falls back to a plain leader with no bus;
- two gloo processes over a `TorchDistBus` (tests/torch_dist_util.py): the
  leader's answers equal a single runtime's and bagel_tpu's token for
  token, the follower ran the same number of ticks and the same stats;
- `serving.server.main` in two gloo processes: the follower ticks, the
  leader's HTTP chat equals a runtime alone's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_bagel
from bagel_tpu.data.tokenizer import MockTokenizer as JMockTokenizer
from bagel_tpu.inference.engine import BagelEngine as JEngine
from bagel_tpu.models import bagel as jbagel
from bagel_tpu_torch.data.tokenizer import MockTokenizer
from bagel_tpu_torch.inference.engine import BagelEngine
from bagel_tpu_torch.serving.multihost import LocalBus, MultiHostFrontend, serve_multihost
from bagel_tpu_torch.serving.runtime import ServingRuntime
from bagel_tpu_torch.utils.bridge import params_from_numpy
from torch_dist_util import run
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

TIMEOUT = 300
PROMPTS = ["what is this?", "just text", "another one"]
RT = dict(slots=2, decode_chunk=3, max_new_default=6)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_bagel()
    tree = jax.tree.map(np.asarray, jbagel.init_bagel_params(jax.random.PRNGKey(0), cfg,
                                                             jnp.float32))
    tree["llm"]["lm_head"]["w"] = tree["llm"]["lm_head"]["w"] * 8.0  # no near ties
    tok = MockTokenizer(cfg.llm.vocab_size)
    engine = BagelEngine(params_from_numpy(tree, "cpu"), cfg, tok, tok.new_token_ids,
                         max_kv=512, device="cpu")
    jtok = JMockTokenizer(cfg.llm.vocab_size)
    jeng = JEngine(jax.tree.map(jnp.asarray, tree), cfg, jtok, jtok.new_token_ids, max_kv=512)
    return cfg, tree, engine, jeng


def _sequential(engine, image, prompt, max_new):
    ctx = engine.init_context()
    if image is not None:
        ctx = engine.update_context_image(image, ctx, vae=False, vit=True)
    ctx = engine.update_context_text(prompt, ctx)
    return engine.gen_text(ctx, max_length=max_new)


def _counts(stats: dict) -> dict:
    """The stats that lockstep processes share: all but the queue wait,
    which each process takes on its own clock."""
    return {k: v for k, v in stats.items() if k != "queue_wait_s"}


def _images():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((28, 28, 3)).astype(np.float32) * 0.3, None, None]


def test_lockstep_leader_follower(setup):
    _, _, engine, jeng = setup
    images = _images()
    bus = LocalBus(n_followers=1)
    leader = MultiHostFrontend(ServingRuntime(engine, **RT), bus=bus, leader=True)
    follower = MultiHostFrontend(ServingRuntime(engine, **RT), bus=bus, leader=False)
    follower.start()
    leader.start()
    try:
        futs = [leader.submit_chat(p, image=im) for p, im in zip(PROMPTS, images)]
        gen = leader.submit_generate("a thing", image_shapes=(32, 32), num_timesteps=3,
                                     cfg_text_scale=1.0, cfg_img_scale=1.0)
        got = [f.result(timeout=TIMEOUT) for f in futs]
        img = gen.result(timeout=TIMEOUT)
    finally:
        leader.stop()
        follower.join(timeout=120)
    with jax.default_matmul_precision("float32"):
        for im, p, g in zip(images, PROMPTS, got):
            assert g == _sequential(engine, im, p, 6) == _sequential(jeng, im, p, 6), p
    assert img["image"].shape == (32, 32, 3)
    assert _counts(follower.stats) == _counts(leader.stats) and follower.ticks == leader.ticks
    assert leader.stats["chat_done"] == 3 and leader.stats["gen_done"] == 1
    assert leader.stats["admitted"] == 3
    assert leader.stats["queue_wait_s"] > 0 and follower.stats["queue_wait_s"] > 0
    assert leader.error is None and follower.error is None
    with pytest.raises(RuntimeError, match="followers take no client traffic"):
        follower.submit_chat("nope")


def test_single_process_fallback(setup):
    _, _, engine, jeng = setup
    fe = serve_multihost(engine, slots=2, decode_chunk=4, max_new_default=5)
    assert fe.leader and fe.bus is None
    fe.start()
    try:
        out = fe.submit_chat("hello").result(timeout=TIMEOUT)
    finally:
        fe.stop()
    with jax.default_matmul_precision("float32"):
        assert out == _sequential(engine, None, "hello", 5) == _sequential(jeng, None, "hello", 5)
    assert fe.stats["chat_done"] == 1


def test_two_gloo_processes(setup, tmp_path):
    cfg, tree, engine, jeng = setup
    prompts = PROMPTS + ["third request"]
    got = run("serve_two", 2, tmp_path, tree=tree, cfg=cfg, prompts=prompts, runtime=RT)
    leader, follower = got
    rt = ServingRuntime(engine, **RT)  # a single runtime, one process
    rt.start()
    try:
        alone = [f.result(timeout=TIMEOUT) for f in [rt.submit_chat(p) for p in prompts]]
    finally:
        rt.stop()
    with jax.default_matmul_precision("float32"):
        want = [_sequential(jeng, None, p, 6) for p in prompts]
    assert leader["answers"] == alone == want
    assert follower["answers"] is None
    assert follower["ticks"] == leader["ticks"]
    assert _counts(follower["stats"]) == _counts(leader["stats"])
    assert leader["stats"]["chat_done"] == leader["stats"]["admitted"] == len(prompts)
    assert leader["stats"]["queue_wait_s"] > 0 and follower["stats"]["queue_wait_s"] > 0


def test_server_main_two_processes(tmp_path):
    """serving.server.main under a group of two processes (JAX's
    server.py:322-337): the follower ticks until the leader stops, and the
    leader's HTTP chat equals a runtime alone's on the same demo engine."""
    from bagel_tpu_torch.serving import app

    argv = ["--device", "cpu", "--port", "0", "--max_kv", "512", "--slots", "2",
            "--decode_chunk", "3"]
    leader, follower = run("serve_main", 2, tmp_path, argv=argv, prompt="hello there")
    assert follower["answer"] is None and leader["stopped"]
    engine, _, _ = app.build_engine(app.parse_args(["--device", "cpu", "--max_kv", "512"]))
    rt = ServingRuntime(engine, slots=2, decode_chunk=3)
    rt.start()
    try:
        alone = rt.submit_chat("hello there", max_new_tokens=6).result(timeout=TIMEOUT)
    finally:
        rt.stop()
    assert alone and leader["answer"] == alone
    assert "ticking until the leader stops" in (tmp_path / "serve_main.rank1.log").read_text()
