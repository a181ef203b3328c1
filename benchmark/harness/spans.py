"""The program's own spans (`bagel_tpu_torch.utils.trace`, recorded while
the traced window's profiler records) and counters (`run.counters`, the
runtime's `stats` at the window's start and end), for the per-layer
readers.

A span counts where it started inside the traced window [tracer.t0,
tracer.t1] (time.perf_counter()); a host span is put on the trace's clock
with `Tracer.us`, the mapping the device's kernels are read on. Each
function returns None where there is nothing to read: a program without
the recorder, a run without a traced window, no such span in it, a
counter the program does not keep.
"""

from __future__ import annotations

import statistics
from typing import List, Optional


def program_spans(run, name: str, **attrs) -> Optional[List[dict]]:
    """The records of the spans named `name` (with these attributes) that
    started in the traced window, or None where there are none."""
    tr = run.tracer
    if tr.t0 is None or tr.t1 is None:
        return None
    try:
        from bagel_tpu_torch.utils import trace
    except ImportError:
        return None
    got = [s for s in trace.spans(tr.t0, tr.t1) if s["name"] == name
           and all(s["attrs"].get(k) == v for k, v in attrs.items())]
    return got or None


def device_ms(run, name: str, **attrs) -> Optional[List[float]]:
    """The device milliseconds of those spans that have them."""
    ms = [s["device_ms"] for s in program_spans(run, name, **attrs) or ()
          if s["device_ms"] is not None]
    return ms or None


def median_device_ms(run, name: str, **attrs) -> Optional[float]:
    ms = device_ms(run, name, **attrs)
    return None if ms is None else statistics.median(ms)


def _merged(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_intervals(tr) -> list:
    """[(lo, hi)] µs on the trace's clock: the stretches of the traced
    window with no kernel on the device, its edges included."""
    lo, hi = tr.us(tr.t0), tr.us(tr.t1)
    out, at = [], lo
    for s, e in tr.busy_intervals():
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def idle_share_under(run, name: str) -> Optional[float]:
    """The share (%) of the traced window in which the device sat idle
    while the host was inside a span named `name`."""
    sp = program_spans(run, name)
    tr = run.tracer
    if sp is None or not tr.kernels or not tr.window_s:
        return None
    host = _merged((tr.us(s["t0"]), tr.us(s["t1"])) for s in sp)
    over, i = 0.0, 0
    for a, b in idle_intervals(tr):
        while i < len(host) and host[i][1] <= a:
            i += 1
        j = i
        while j < len(host) and host[j][0] < b:
            over += min(b, host[j][1]) - max(a, host[j][0])
            j += 1
    return 100.0 * over / 1e6 / tr.window_s


def counter_delta(run, name: str) -> Optional[float]:
    """The counter's change over the window (end - start)."""
    a, b = run.counters.get("start"), run.counters.get("end")
    if not a or not b or name not in a or name not in b:
        return None
    return b[name] - a[name]


def per_admission(run, name: str) -> Optional[float]:
    """A counter's change over the window per request admitted in it."""
    n, admitted = counter_delta(run, name), counter_delta(run, "admitted")
    if n is None or not admitted:
        return None
    return n / admitted
