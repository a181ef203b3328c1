"""The median device time of the traced slice's decode chunks (the
program's `runtime.decode` spans: events around the decode program's
launch)."""

from benchmark.harness import spans


def read(run):
    return spans.median_device_ms(run, "runtime.decode")
