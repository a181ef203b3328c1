"""The admissions' prefills (the program's `runtime.prefill` spans: the
slot rows' reset, SigLIP, the image rounds and the text block), their
device time over the traced slice. The idle among one admission's own
kernels counts in it, so it does not add up with the idle shares."""

from benchmark.harness import spans


def read(run):
    ms = spans.device_ms(run, "runtime.prefill")
    if ms is None or not run.tracer.window_s:
        return None
    return 100.0 * sum(ms) / 1e3 / run.tracer.window_s
