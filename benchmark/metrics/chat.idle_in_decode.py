"""The share of the traced slice with the device idle while the scheduler
is in a decode chunk (the program's `runtime.decode` spans: the lengths'
read, the inputs' copies, the launch, the tokens' read)."""

from benchmark.harness import spans


def read(run):
    return spans.idle_share_under(run, "runtime.decode")
