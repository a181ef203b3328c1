"""The check catches a broken timed path: each fault the cells can have,
planted in the program underneath a run on the CPU at a micro size, makes
`correct` false; so does the control (the program's w8a8 path), whose gaps
exceed the program's own. (One card: no exchange between cards to drop.)"""

import contextlib

import pytest
import torch

from benchmark.tests.test_bench_reference import run_session


@contextlib.contextmanager
def patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def t2i_state_unchanged(orig):
    def phase(params, cfg, x_t, *a, **kw):
        orig(params, cfg, x_t, *a, **kw)
        return x_t
    return phase


def t2i_half_batch(orig):
    def make(*a, **kw):
        flow_v = orig(*a, **kw)

        def v(x, t):
            out = flow_v(x, t)
            h = out.shape[0] // 2
            if h:
                out = out.clone()
                out[h:] = out[:h].mean(0)
            return out
        return v
    return make


def t2i_answer_altered(orig):
    def dec(*a, **kw):
        img = orig(*a, **kw).clone()
        img[:, :4, :4] += 0.5
        return img
    return dec


@pytest.mark.parametrize("name,make", [("_denoise_phase", t2i_state_unchanged),
                                       ("_make_flow_v", t2i_half_batch),
                                       ("vae_decode", t2i_answer_altered)])
def test_t2i_fault_fails(name, make):
    from bagel_tpu_torch.inference import engine

    with patched(engine, name, make):
        run = run_session("t2i_closed")
    assert not run.correct, run.comparisons


def chat_state_unchanged(orig):
    def step(params, cfg, st, *a, **kw):
        length = st.cache.length.clone()
        orig(params, cfg, st, *a, **kw)
        st.cache.length.copy_(length)
    return step


def chat_half_batch(orig):
    def logits(params, hidden, *a, **kw):
        out = orig(params, hidden, *a, **kw)
        h = out.shape[0] // 2
        if h:
            out = out.clone()
            out[h:] = out[:h].mean(0)
        return out
    return logits


def chat_token_altered(orig):
    def decode(*a, **kw):
        toks, cache = orig(*a, **kw)
        toks = toks.clone()
        toks[:, 0] = (toks[:, 0] + 1) % 500
        return toks, cache
    return decode


@pytest.mark.parametrize("name,make", [("decode_step", chat_state_unchanged),
                                       ("lm_logits", chat_half_batch),
                                       ("decode_text", chat_token_altered)])
def test_chat_fault_fails(name, make):
    from bagel_tpu_torch.models import qwen2

    with patched(qwen2, name, make):
        run = run_session("chat_closed", check_requests=16)
    assert not run.correct, run.comparisons


@pytest.mark.parametrize("kind,number", [("t2i_closed", "velocity_gap"),
                                         ("t2i_closed", "combine_gap"),
                                         ("chat_closed", "logit_gap")])
def test_control_fails(kind, number):
    """The control (the program's w8a8 decoder; for text-to-image also the
    CFG combination in bfloat16) reads more than three times the float
    path's gap (0 at this size), and fails the micro limits."""
    from benchmark.harness import program

    # at this size a chat needs answers of some length before int8 flips a token
    kw = {"answer_tokens": [16, 32], "seconds": 1.0} if kind == "chat_closed" else {}
    ok = {n: v for n, v, _ in run_session(kind, **kw).comparisons}[number]
    orig = program.engine

    def w8a8(run, params):
        run.state["quant"] = "w8a8"
        return orig(run, params)

    program.engine = w8a8
    try:
        run = run_session(kind, check_requests=16, **kw)
    finally:
        program.engine = orig
    got = {n: v for n, v, _ in run.comparisons}[number]
    assert not run.correct and got > 3 * ok
