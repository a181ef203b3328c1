"""Spans of the program: named stretches of host time, with the device
time between two CUDA events where asked, recorded in memory while a
`torch.profiler` session records in this process, and at no other time.

    with trace.span("engine.vae_decode", device):       # device time too
        ...
    with trace.span("runtime.decode") as sp:             # host time ...
        sp.device_start(device)                          # ... device time
        ...                                              #     of a part
        sp.device_stop()
    trace.spans(lo, hi)   # plain records of the spans that started in [lo, hi]

The switch is torch's own process-wide flag, set while a profiler session
runs (`torch.autograd.profiler._is_profiler_enabled`); the C check beside
it (`torch._C._autograd._profiler_enabled()`) reads the calling thread's
state and is False on a thread other than the one that started the
session, such as a serving runtime's scheduler. No environment variable or
option turns spans on, and nothing is written to a file.

While nothing records, `span` tests the flag and returns one shared object
whose methods do nothing: no allocation, no lock, no CUDA event. While a
session records, a span stamps `time.perf_counter()` at entry and exit
(the clock a profiler trace is mapped onto with one offset), the thread,
its parent (the innermost span open on that thread) and the integer
attributes it is given; with a CUDA `device` it records a timing event on
that device's current stream at entry and exit, or, through
`device_start` / `device_stop`, around a part of it. No event is recorded
on a stream that is capturing a CUDA graph. The events are read in
`spans`, after a synchronize of the last one: outside any timed stretch.

The spans do not enter the profiler's own events (no `record_function`,
no NVTX range): a profiler trace holds the program's kernels and
operations alone. The last MAX_SPANS spans are kept.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, Optional

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 65536

_done: "collections.deque[_Span]" = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_open = threading.local()  # .stack: the thread's open spans, innermost last


def recording() -> bool:
    """Whether spans are recorded now: a profiler session records in this
    process."""
    return _profiler._is_profiler_enabled


class _Off:
    """What `span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def device_start(self, device) -> None:
        pass

    def device_stop(self) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "thread", "t0", "t1", "attrs", "device",
                 "_ev0", "_ev1", "_ms")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self.device, self.attrs = name, device, attrs
        self.id = next(_ids)
        self.parent = self.t1 = self._ev0 = self._ev1 = self._ms = None

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self.thread = threading.get_ident()
        self.t0 = time.perf_counter()
        if self.device is not None:
            self.device_start(self.device)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.device_stop()
        self.t1 = time.perf_counter()
        _open.stack.pop()
        _done.append(self)
        return None

    def device_start(self, device) -> None:
        """A timing event on `device`'s current stream (a CUDA device, not
        capturing): the device time starts here."""
        if device is None or device.type != "cuda" or torch.cuda.is_current_stream_capturing():
            return
        self._ev0 = torch.cuda.Event(enable_timing=True)
        self._ev0.record(torch.cuda.current_stream(device))
        self.device = device

    def device_stop(self) -> None:
        """The device time ends here (once)."""
        if self._ev0 is None or self._ev1 is not None or torch.cuda.is_current_stream_capturing():
            return
        self._ev1 = torch.cuda.Event(enable_timing=True)
        self._ev1.record(torch.cuda.current_stream(self.device))

    def device_ms(self) -> Optional[float]:
        if self._ms is None and self._ev1 is not None:
            self._ev1.synchronize()
            self._ms = self._ev0.elapsed_time(self._ev1)
            self._ev0 = self._ev1 = None
        return self._ms

    def record(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "thread": self.thread, "t0": self.t0, "t1": self.t1,
                "device_ms": self.device_ms(), "attrs": dict(self.attrs)}


def span(name: str, device=None, rows: Optional[int] = None, full: Optional[int] = None):
    """A span named `name` (a context manager). `device`: a torch.device
    whose current stream times the span (none on the CPU). `rows`, `full`:
    integer attributes its readers select by."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    attrs = {}
    if rows is not None:
        attrs["rows"] = int(rows)
    if full is not None:
        attrs["full"] = int(full)
    return _Span(name, device, attrs)


def spans(lo: float = float("-inf"), hi: float = float("inf")) -> List[dict]:
    """Every kept span that has ended and started in [lo, hi]
    (time.perf_counter()), in the order they ended: {name, id, parent (the
    enclosing span's id, or None), thread, t0, t1, device_ms (None without
    device time), attrs}. Waits for the device to reach each span's last
    event."""
    return [s.record() for s in _done.copy() if lo <= s.t0 <= hi]
