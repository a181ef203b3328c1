"""B1 at T > 1 (the admissions' image and text blocks) over the traced
slice's chunks: the bound of the requests each chunk admitted (those it
delivered a first token to) over the kernel's device time before it."""

from benchmark.harness import work
from benchmark.traffic.chat_closed import pixels
from benchmark.harness.chunks import traced_spans


def read(run):
    f = b = t = 0.0
    for lo, hi, got in traced_spans(run):
        new = [r for r, first, _ in got if first == 0]
        if not new:
            continue
        t += run.tracer.kernel_s("flash_cached_attention_kernel", lo=lo, hi=hi)
        for r in new:
            ff, bb = work.chat_prefill_b1_work(run.model, len(r["prompt"]), pixels(r))
            f, b = f + ff, b + bb
    if t <= 0 or f == 0:
        return None
    return 100.0 * work.bound_ms_at(f, b)[0] / 1e3 / t
