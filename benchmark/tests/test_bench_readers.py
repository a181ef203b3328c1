"""The per-layer readers on a synthetic run: chunks told apart by their
deliveries, kernels matched to the chunk they ran for, shares by hand."""

import importlib.util
import json
import os
import types

import pytest

from benchmark.harness.runstate import Run
from benchmark.harness.trace import Tracer
from benchmark.tests.micro import ROOT


def reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("r_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def fake_run():
    with open(os.path.join(ROOT, "benchmark", "configs", "bagel-7b-mot.json")) as f:
        config = json.load(f)
    tr = Tracer(False)
    tr.t0, tr.t1, tr.offset_us = 10.0, 12.0, 0.0
    tr.kernels = [("flash_cached_attention_kernel", 10.55e6, 10.55e6 + 1000),
                  ("flash_decode_split_kernel<bf16>", 10.6e6, 10.6e6 + 100),
                  ("flash_decode_combine_kernel", 10.61e6, 10.61e6 + 50),
                  ("gemv", 10.62e6, 10.62e6 + 300),
                  ("flash_decode_split_kernel<bf16>", 10.8e6, 10.8e6 + 100)]
    log = [{"prompt": "x" * 100, "image": None, "chunks": [(10.5, [1] * 16), (10.7, [1] * 16)],
            "t_send": 10.3, "ok": True},
           {"prompt": "y" * 20, "image": (0, 140, 280), "chunks": [(10.7, [2] * 16),
                                                                    (10.9, [2] * 8)],
            "t_send": 10.52, "ok": True}]
    run = Run(cell={"traffic": {"slots": 8}}, config=config, seed=0, seconds=2,
              device=None, tracer=tr, log=log, t_start=10.0, t_end=12.0)
    run.counters = {"start": {"tokens_out": 0, "decode_forwards": 0},
                    "end": {"tokens_out": 56, "decode_forwards": 16}}
    return run


def test_prefill_roofline_by_hand():
    run = fake_run()
    # r2: an image of 10 x 20 patches + start, end; then 22 text tokens
    n_img, n_txt = 202, 22
    pairs = n_img * n_img + n_txt * n_img + n_txt * (n_txt + 1) // 2
    flops = 4 * 128 * 28 * pairs * 28
    # q and out once, the live K/V once, bf16, each call; at these sizes the bytes bound
    by = 2 * (2 * n_img * 28 * 128 + 2 * n_img * 4 * 128)
    by += 2 * (2 * n_txt * 28 * 128 + 2 * (n_img + n_txt) * 4 * 128)
    want = 100 * max(flops / 989e12, by * 28 / 3.35e12) / 1000e-6
    assert reader("chat.b1_prefill_roofline")(run) == pytest.approx(want, rel=1e-9)


def test_decode_roofline_counts_the_chunk_it_timed():
    run = fake_run()
    # chunk (10.5, 10.7]: r1's tokens 16..31 and r2's 0..15; (10.7, 10.9]: r2's 16..23
    by = 0
    for past in [100 + 2 + j for j in range(16, 32)] + [224 + j for j in range(24)]:
        by += 2 * (2 * 28 * 128 + 2 * (past + 1) * 4 * 128) * 28
    want = 100 * by / 3.35e12 / 250e-6
    assert reader("chat.b1_decode_roofline")(run) == pytest.approx(want, rel=1e-9)


def test_slot_fill_launches_and_idle():
    run = fake_run()
    assert reader("chat.slot_fill")(run) == pytest.approx(100 * 56 / (16 * 8))
    assert reader("chat.launches_per_token")(run) == pytest.approx(5 / 56)
    busy = (1000 + 100 + 50 + 300 + 100) / 1e6
    assert reader("chat.idle_share")(run) == pytest.approx(100 * (1 - busy / 2.0))
    assert 0 < reader("chat.mfu")(run) < 100


def test_readers_return_nothing_without_a_trace():
    run = fake_run()
    run.tracer = Tracer(False)
    for name in ("chat.b1_prefill_roofline", "chat.b1_decode_roofline", "chat.idle_share",
                 "chat.launches_per_token", "t2i.b1_roofline", "t2i.idle_share"):
        assert reader(name)(run) is None
