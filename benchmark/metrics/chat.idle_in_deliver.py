"""The share of the traced slice with the device idle while the scheduler
delivers a chunk's tokens (the program's `runtime.deliver` spans: the
clients' `on_tokens`, retirements, the answers' text)."""

from benchmark.harness import spans


def read(run):
    return spans.idle_share_under(run, "runtime.deliver")
