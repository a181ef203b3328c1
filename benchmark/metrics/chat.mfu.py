"""The served work's share of the card's bf16 peak over the window: the
prefill (SigLIP, connector, decoder) of every request whose first token
came inside the window, and a decode forward (decoder, attention over its
cached keys, the vocabulary head) for every token delivered inside it."""

from benchmark.harness import work
from benchmark.traffic.chat_closed import pixels


def read(run):
    flops = 0
    for r in run.log:
        chunks = r["chunks"]
        if chunks and run.t_start <= chunks[0][0] <= run.t_end:
            flops += work.chat_prefill_flops(run.model, len(r["prompt"]), pixels(r))
        n_img, n_txt = work.chat_prefill(run.model, len(r["prompt"]), pixels(r))
        j = 0
        for when, ids in chunks:
            for _ in ids:
                if run.t_start <= when <= run.t_end:
                    flops += work.decode_token_flops(run.model, n_img + n_txt + j)
                j += 1
    if not flops:
        return None
    return 100.0 * flops / run.window_s / work.PEAK_BF16
