"""The share of the traced slice with the device idle while the scheduler
admits (the program's `runtime.admit` spans: the queue, the admission plan,
the prefill's launches)."""

from benchmark.harness import spans


def read(run):
    return spans.idle_share_under(run, "runtime.admit")
