"""B1's decode pair (split + combine) over the traced slice's decode
chunks: the bytes bound of the tokens each chunk delivered (each over its
cached keys) over the pair's device time in that chunk. Steps that deliver
no token (a row past its budget or its eos within a chunk) are timed and
not counted."""

from benchmark.harness import work
from benchmark.traffic.chat_closed import pixels
from benchmark.harness.chunks import traced_spans


def read(run):
    f = b = t = 0.0
    for lo, hi, got in traced_spans(run):
        t += run.tracer.kernel_s("flash_decode_split_kernel", "flash_decode_combine_kernel",
                                 lo=lo, hi=hi)
        for r, first, n in got:
            n_img, n_txt = work.chat_prefill(run.model, len(r["prompt"]), pixels(r))
            for j in range(first, first + n):
                ff, bb = work.decode_token_work(run.model, n_img + n_txt + j)
                f, b = f + ff, b + bb
    if t <= 0 or b == 0:
        return None
    return 100.0 * work.bound_ms_at(f, b)[0] / 1e3 / t
