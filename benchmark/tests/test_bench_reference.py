"""The plain reference agrees with the port at a micro size on the CPU
(both in float32): each piece alone, and each session's whole check."""

import importlib

import numpy as np
import torch

from benchmark.harness.program import bagel_config
from benchmark.harness.weights import make_params
from benchmark.reference import bagel as ref
from benchmark.tests.micro import make_run, model


def test_vae_decode_matches_the_port():
    from bagel_tpu_torch.models.vae import vae_decode

    m = model()
    params = make_params(m, 5, "cpu", torch.float32)
    z = torch.randn((8, 6, 4), generator=torch.Generator().manual_seed(1))
    want = vae_decode(params["vae"], bagel_config(m).vae, z[None])[0]
    got = ref.vae_decode(params["vae"], m["vae"], z)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


def test_siglip_matches_the_port():
    from bagel_tpu_torch.models.bagel import encode_vit_tokens

    m = model()
    cfg = bagel_config(m)
    params = make_params(m, 6, "cpu", torch.float32)
    img = np.random.default_rng(0).uniform(-1, 1, (42, 56, 3)).astype(np.float32)
    p, pos = ref.image_patches(img, 14, m["vit_max_num_patch_per_side"])
    want = encode_vit_tokens(params, cfg, torch.as_tensor(p), torch.as_tensor(pos),
                             torch.ones(len(pos), dtype=torch.int32), attn_impl="dense")
    vis = ref.siglip(params["vit"], m["vit"], torch.as_tensor(p), torch.as_tensor(pos))
    got = ref.linear(torch.nn.functional.gelu(ref.linear(vis, params["connector"]["fc1"]),
                                              approximate="tanh"), params["connector"]["fc2"])
    got = got + params["vit_pos_embed"][torch.as_tensor(pos)]
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def run_session(kind, **kw):
    run = make_run(kind, **kw)
    s = importlib.import_module(f"benchmark.sessions.{kind}")
    s.setup(run)
    s.window(run)
    s.free(run)
    s.check(run)
    return run


def test_t2i_session_agrees_with_the_reference():
    run = run_session("t2i_closed")
    assert run.attempted >= 1 and run.failed == 0
    got = {n: v for n, v, _ in run.comparisons}
    assert got["velocity_gap"] < 1e-5 and got["combine_gap"] < 1e-6
    assert got["image_share"] < 0.1  # a value or two on a rounding edge of the 8-bit levels
    assert run.correct and run.values["t2i_image_s"] > 0


def test_chat_session_agrees_with_the_reference():
    run = run_session("chat_closed")
    assert run.attempted >= 1 and run.failed == 0
    got = {n: v for n, v, _ in run.comparisons}
    assert got["logit_gap"] < 1e-4 and got["served_text"] == 0
    assert run.state["checked"]["tokens"] > 0
    assert run.correct and run.values["chat_tokens_per_s"] > 0
    assert any(r["image"] is not None for r in run.log)
