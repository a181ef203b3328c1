"""The mean seconds a request admitted in the window waited from its
submission to the start of its prefill (the runtime's `queue_wait_s` over
`admitted`)."""

from benchmark.harness import spans


def read(run):
    return spans.per_admission(run, "queue_wait_s")
