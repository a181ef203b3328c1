"""The port's span recorder (bagel_tpu_torch/utils/trace.py) on the CPU.

Bars: with no profiler session nothing is stored and no CUDA event is made,
even for a span on a CUDA device; torch's process-wide flag that the
recorder reads flips with a `torch.profiler.profile` session, on every
thread; under a session spans nest per thread, carry their attributes and
lie on time.perf_counter(), and `spans(lo, hi)` selects them by start.
"""

import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile

from bagel_tpu_torch.utils import trace


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def test_no_profiler_no_span_and_no_event(monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **kw: made.append(1))
    assert not trace.recording()
    before = len(trace.spans())
    t0 = time.perf_counter()
    for dev in (None, torch.device("cpu"), torch.device("cuda", 0)):
        with trace.span("engine.denoise_step", dev, rows=3) as sp:
            sp.device_start(dev)
            sp.device_stop()
        assert sp is trace._OFF
    assert trace.spans(t0) == [] and len(trace.spans()) == before and made == []


def test_the_flag_flips_with_a_profiler_session_on_every_thread():
    seen = []

    def look():
        seen.append(trace.recording())

    assert not trace.recording()
    with _session():
        assert trace.recording()
        t = threading.Thread(target=look)
        t.start()
        t.join()
    assert not trace.recording()
    assert seen == [True]


def test_spans_nest_per_thread_with_their_attributes():
    t0 = time.perf_counter()
    with _session():
        with trace.span("outer") as outer:
            with trace.span("inner", torch.device("cpu"), rows=6, full=True):
                time.sleep(0.002)
        other = threading.Thread(target=lambda: trace.span("alone").__enter__().__exit__(
            None, None, None))
        other.start()
        other.join()
    t1 = time.perf_counter()
    with trace.span("after"):
        pass
    got = {s["name"]: s for s in trace.spans(t0, t1)}
    assert set(got) == {"outer", "inner", "alone"}
    inner, out, alone = got["inner"], got["outer"], got["alone"]
    assert inner["parent"] == outer.id == out["id"] and out["parent"] is None
    assert alone["parent"] is None and alone["thread"] != out["thread"] == inner["thread"]
    assert out["t0"] <= inner["t0"] < inner["t1"] <= out["t1"]
    assert inner["t1"] - inner["t0"] >= 0.002
    assert inner["attrs"] == {"rows": 6, "full": 1} and out["attrs"] == {}
    assert inner["device_ms"] is None  # no device time on the CPU
    assert trace.spans(inner["t0"], inner["t0"]) == [inner]
