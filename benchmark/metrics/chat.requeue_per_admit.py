"""Requests put back into the queue to wait for KV capacity, per request
admitted in the window (the runtime's `requeued` over `admitted`)."""

from benchmark.harness import spans


def read(run):
    return spans.per_admission(run, "requeued")
