"""What one run of a cell carries from set-up through the window to the
check and the metric readers."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class Run:
    cell: dict  # benchmark/workloads/<name>.json
    config: dict  # benchmark/configs/<config>.json
    seed: int
    seconds: float
    device: Any
    tracer: Any  # harness.trace.Tracer
    t_start: Optional[float] = None  # the window, on time.perf_counter()
    t_end: Optional[float] = None
    log: list = dataclasses.field(default_factory=list)  # one record a request or step
    values: dict = dataclasses.field(default_factory=dict)  # end-to-end metrics by name
    counters: dict = dataclasses.field(default_factory=dict)  # the program's, over the window
    comparisons: list = dataclasses.field(default_factory=list)  # (name, value, limit)
    attempted: int = 0
    failed: int = 0
    state: dict = dataclasses.field(default_factory=dict)  # the session's own

    @property
    def traffic(self) -> dict:
        return self.cell["traffic"]

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def dtype(self):
        """The type the decoder and the tower are served in."""
        import torch

        return getattr(torch, self.config["dtype"])

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def compare(self, name: str, value: float, limit: float) -> None:
        self.comparisons.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.comparisons)
                and all(v <= lim for _, v, lim in self.comparisons))
