"""The serving runtime's decode chunks as a client sees them: every
request's `on_tokens` deliveries of one chunk come within moments of each
other, and chunks lie a decode chunk's time apart. The device's work of
chunk k (its admission's prefill, then its decode steps) runs between the
deliveries of chunk k - 1 and those of chunk k."""

from __future__ import annotations

GAP_S = 0.02  # deliveries further apart than this belong to different chunks


def chunks(log: list) -> list:
    """[(first delivery, last delivery, [(request, index of its first token
    in the chunk, tokens)])], in time order (time.perf_counter())."""
    ev = []
    for r in log:
        done = 0
        for when, ids in r["chunks"]:
            ev.append((when, r, done, len(ids)))
            done += len(ids)
    ev.sort(key=lambda e: e[0])
    out = []
    for when, r, first, n in ev:
        if out and when - out[-1][1] <= GAP_S:
            out[-1][1] = when
            out[-1][2].append((r, first, n))
        else:
            out.append([when, when, [(r, first, n)]])
    return out


def traced_spans(run) -> list:
    """[(lo_us, hi_us, deliveries)] on the trace's clock: the device work
    behind each chunk whose previous chunk was delivered inside the traced
    slice, and which was delivered inside it too."""
    tr = run.tracer
    if tr.t1 is None:
        return []
    cs = chunks(run.log)
    return [(tr.us(a[1]), tr.us(b[0]), b[2]) for a, b in zip(cs, cs[1:])
            if a[1] >= tr.t0 and b[1] <= tr.t1]
