"""Kernels the profiler recorded in the traced slice over the tokens
delivered in it."""


def read(run):
    tr = run.tracer
    if tr.t1 is None or not tr.kernels:
        return None
    toks = sum(len(ids) for r in run.log for t, ids in r["chunks"] if tr.t0 <= t <= tr.t1)
    return tr.kernel_count() / toks if toks else None
