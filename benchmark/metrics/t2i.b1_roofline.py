"""B1 at T > 1 in the traced image: the bound of its calls (the frozen
counts at the image's shapes) over the device time of its kernel."""

from benchmark.harness import work


def read(run):
    traced = [e for e in run.log if e.get("traced") and e.get("ok")]
    t = run.tracer.kernel_s("flash_cached_attention_kernel") if traced else 0.0
    if t <= 0:
        return None
    f, b = work.t2i_b1_work(run.model, run.traffic, len(traced[0]["prompt"]))
    return 100.0 * work.bound_ms_at(f, b)[0] / 1e3 / t
