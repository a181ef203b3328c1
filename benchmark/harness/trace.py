"""The device trace of a run's traced window: torch.profiler's record of
the card (and of the host's operations, to name idle gaps), reduced to
kernel intervals, the busy time and a breakdown.

`profile_session` is a frozen copy of `chip_smoke.py`'s (a session that
records the card; a retry waits a little and records the host too);
`prime` runs it during set-up until a session records the card, since a
first session now and then records no CUDA activity.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch

PROFILE_TRIES = 6


def profile_session(attempt: int, host: bool = False):
    from torch.profiler import ProfilerActivity, profile

    if attempt:
        time.sleep(0.2 * attempt)
    activities = [ProfilerActivity.CUDA]
    if host or attempt % 2:
        activities.insert(0, ProfilerActivity.CPU)
    return profile(activities=activities)


def _events(prof) -> Tuple[list, list]:
    """([(name, start_us, end_us)] of the device, the same of the host)."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if results is not None:
        for e in results.events():
            s = e.start_ns() / 1e3
            end = s + e.duration_ns() / 1e3
            if end <= s:
                continue
            (dev if e.device_type() == cuda else host).append((e.name(), s, end))
        return dev, host
    for e in prof.events():
        s, end = e.time_range.start, e.time_range.end
        if end > s:
            (dev if e.device_type == cuda else host).append((e.name, s, end))
    return dev, host


def prime(device) -> bool:
    """Profile a few kernels until a session records the card."""
    x = torch.ones((256, 256), device=device)
    for attempt in range(PROFILE_TRIES):
        with profile_session(attempt) as prof:
            for _ in range(4):
                x = x @ x * 1e-3
            torch.cuda.synchronize(device)
        if _events(prof)[0]:
            return True
    return False


def short_name(name: str) -> str:
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    return n.split("(")[0].split("<")[0][:80]


class Tracer:
    """Records one traced window (`start` ... `stop`) when enabled."""

    def __init__(self, enabled: bool, device=None):
        self.enabled = enabled
        self.device = device
        self._prof = None
        self._stopped = False
        self.t0 = self.t1 = None
        self.kernels: List[tuple] = []  # (name, start_us, end_us) on the device
        self.host: List[tuple] = []

    def start(self):
        if not self.enabled or self._prof is not None:
            return
        torch.cuda.synchronize(self.device)
        self._prof = profile_session(0, host=True)
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        # the profiler stamps its events on the wall clock (ns)
        self.offset_us = time.time_ns() / 1e3 - self.t0 * 1e6

    def us(self, t: float) -> float:
        """A time.perf_counter() reading on the trace's clock (µs)."""
        return t * 1e6 + self.offset_us

    def end(self):
        """Ends the traced window here; the profiler records on until
        `stop`, and what starts after this is left out."""
        if self._prof is not None and self.t1 is None:
            self.t1 = time.perf_counter()

    def stop(self):
        """Stops the profiler. A session that serves from other threads
        calls it once they are idle: its stop reads the profiler's buffers,
        and one stopped under the serving threads' graph replays was seen to
        hang."""
        if self._prof is None or self._stopped:
            return
        self.end()
        torch.cuda.synchronize(self.device)
        self._prof.stop()
        self._stopped = True

    def collect(self):
        """Reads the events of the window [start, end] (`end`'s stamp)."""
        if self._prof is None:
            return
        self.stop()
        lo, hi = self.us(self.t0), self.us(self.t1)
        dev, host = _events(self._prof)
        self.kernels = sorted((e for e in dev if lo <= e[1] < hi), key=lambda e: e[1])
        self.kernels = [(n, s, min(e, hi)) for n, s, e in self.kernels]
        self.host = [e for e in host if e[2] >= lo and e[1] < hi]
        self._prof = None

    @property
    def window_s(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def busy_intervals(self) -> list:
        out = []
        for _, s, e in self.kernels:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_s(self, *pieces: str, lo: float = float("-inf"), hi: float = float("inf")) -> float:
        """Device seconds of the kernels whose name holds one of `pieces`
        (and that start in [lo, hi) µs on the trace's clock)."""
        return sum(e - s for n, s, e in self.kernels
                   if lo <= s < hi and any(p in n for p in pieces)) / 1e6

    def kernel_count(self) -> int:
        return len(self.kernels)

    def breakdown(self, top: int = 10) -> dict:
        by = {}
        for n, s, e in self.kernels:
            k = short_name(n)
            by[k] = by.get(k, 0.0) + (e - s) / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in gaps:
            mid = (a + b) / 2
            over = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            what = min(over)[1] if over else "no host operation recorded"
            named.append([f"host: {what[:80]}", (b - a) / 1e6])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
