"""The runtime's own counters over the window: tokens delivered over the
slot-steps its decode chunks ran (`stats["tokens_out"]` over
`stats["decode_forwards"]` x slots); a slot idle to a chunk's end, or
free, lowers it."""


def read(run):
    a, b = run.counters.get("start"), run.counters.get("end")
    if not a or not b:
        return None
    steps = b["decode_forwards"] - a["decode_forwards"]
    if steps <= 0:
        return None
    return 100.0 * (b["tokens_out"] - a["tokens_out"]) / (steps * run.traffic["slots"])
