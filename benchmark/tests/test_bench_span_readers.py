"""The readers of the program's spans and counters on a synthetic run:
hand-made spans in and out of the traced window, kernels on the trace's
clock, each number worked out by hand; and nothing read (None, no error)
from a program without the recorder or the counters, as before they
existed."""

import sys

import pytest

from benchmark.harness.runstate import Run
from benchmark.harness.trace import Tracer
from benchmark.tests.test_bench_readers import reader

SPAN_READERS = ("t2i.cfg_step_ms", "t2i.vae_decode_ms", "chat.decode_chunk_ms",
                "chat.prefill_share", "chat.idle_in_admit", "chat.idle_in_decode",
                "chat.idle_in_deliver")
COUNTER_READERS = ("chat.queue_wait_s", "chat.requeue_per_admit")


def sp(name, t0, t1, ms=None, parent=None, **attrs):
    return {"name": name, "id": id(attrs), "parent": parent, "thread": 1, "t0": t0, "t1": t1,
            "device_ms": ms, "attrs": attrs}


SPANS = [
    # the traced window is [10, 12] s; the trace's clock is perf_counter in µs
    sp("runtime.decode", 9.0, 9.2, 999.0),  # started before the window
    sp("runtime.deliver", 9.9, 10.05),  # over the first idle stretch, started before
    sp("runtime.admit", 10.25, 10.45),
    sp("runtime.prefill", 10.26, 10.44, 150.0),
    sp("runtime.decode", 10.45, 10.6, 120.0),
    sp("runtime.decode", 10.95, 11.1, 140.0),
    sp("runtime.deliver", 11.1, 11.15),
    sp("runtime.decode", 11.5, 11.95, 160.0),
    sp("runtime.prefill", 11.6, 11.7, 50.0),
    sp("runtime.deliver", 12.5, 12.6),  # after the window
    sp("engine.denoise_step", 10.0, 10.4, 400.0, rows=3),
    sp("engine.denoise_step", 10.4, 10.8, 420.0, rows=3),
    sp("engine.denoise_step", 10.8, 11.2, 410.0, rows=3),
    sp("engine.denoise_step", 11.2, 11.4, 200.0, rows=1),
    sp("engine.vae_decode", 11.4, 11.8, 360.0),
    sp("engine.vae_decode", 12.1, 12.5, 999.0),  # the next image's
]


@pytest.fixture
def run(monkeypatch):
    from bagel_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "spans", lambda lo, hi: [s for s in SPANS if lo <= s["t0"] <= hi])
    tr = Tracer(False)
    tr.t0, tr.t1, tr.offset_us = 10.0, 12.0, 0.0
    # busy 10.1-10.3, 10.5-11.0 (two kernels), 11.2-11.9 s: idle 10.0-10.1,
    # 10.3-10.5, 11.0-11.2, 11.9-12.0 (0.6 s)
    tr.kernels = [("a", 10.1e6, 10.3e6), ("b", 10.5e6, 10.8e6), ("c", 10.7e6, 11.0e6),
                  ("d", 11.2e6, 11.9e6)]
    r = Run(cell={"traffic": {"slots": 8}}, config={}, seed=0, seconds=2, device=None,
            tracer=tr, t_start=8.0, t_end=12.0)
    r.counters = {"start": {"admitted": 10, "queue_wait_s": 1.0, "requeued": 2},
                  "end": {"admitted": 30, "queue_wait_s": 5.0, "requeued": 7}}
    return r


def test_device_times_by_hand(run):
    assert reader("t2i.cfg_step_ms")(run) == pytest.approx(410.0)  # rows 3 only
    assert reader("t2i.vae_decode_ms")(run) == pytest.approx(360.0)
    assert reader("chat.decode_chunk_ms")(run) == pytest.approx(140.0)  # 120, 140, 160
    assert reader("chat.prefill_share")(run) == pytest.approx(100 * 0.2 / 2.0)


def test_idle_under_each_span_by_hand(run):
    admit = reader("chat.idle_in_admit")(run)
    decode = reader("chat.idle_in_decode")(run)
    deliver = reader("chat.idle_in_deliver")(run)
    assert admit == pytest.approx(100 * 0.15 / 2.0)  # 10.3-10.45
    assert decode == pytest.approx(100 * (0.05 + 0.1 + 0.05) / 2.0)
    assert deliver == pytest.approx(100 * 0.05 / 2.0)  # 11.1-11.15; the others lie outside
    assert admit + decode + deliver <= reader("chat.idle_share")(run)
    assert reader("chat.idle_share")(run) == pytest.approx(100 * 0.6 / 2.0)


def test_counters_by_hand(run):
    assert reader("chat.queue_wait_s")(run) == pytest.approx(4.0 / 20)
    assert reader("chat.requeue_per_admit")(run) == pytest.approx(5 / 20)


def test_nothing_without_the_recorder(run, monkeypatch):
    import bagel_tpu_torch.utils

    monkeypatch.delattr(bagel_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "bagel_tpu_torch.utils.trace", None)
    for name in SPAN_READERS:
        assert reader(name)(run) is None, name


def test_nothing_without_the_counters(run):
    run.counters = {"start": {"chat_done": 0, "tokens_out": 0},
                    "end": {"chat_done": 5, "tokens_out": 80}}
    for name in COUNTER_READERS:
        assert reader(name)(run) is None, name
    run.counters = {}
    for name in COUNTER_READERS:
        assert reader(name)(run) is None, name


def test_nothing_without_a_span_or_a_window(run):
    run.tracer.t0, run.tracer.t1 = 20.0, 22.0  # no span starts there
    for name in SPAN_READERS:
        assert reader(name)(run) is None, name
    run.tracer = Tracer(False)  # no traced window
    for name in SPAN_READERS:
        assert reader(name)(run) is None, name
    run.counters["end"]["admitted"] = 10  # nobody admitted
    for name in COUNTER_READERS:
        assert reader(name)(run) is None, name
