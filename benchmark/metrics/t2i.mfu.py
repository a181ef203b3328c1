"""The whole image's share of the card's bf16 peak: the model FLOPs of
each finished image (prefills, denoise forwards, adapters, VAE decode;
`harness.work.t2i_image_flops`) over its time from call to image, summed
over the images the profiler did not record."""

from benchmark.harness import work


def read(run):
    done = [e for e in run.log if e.get("ok")]
    plain = [e for e in done if not e.get("traced")] or done
    if not plain:
        return None
    flops = sum(work.t2i_image_flops(run.model, run.traffic, len(e["prompt"])) for e in plain)
    return 100.0 * flops / sum(e["t_done"] - e["t_send"] for e in plain) / work.PEAK_BF16
