"""The traced image's denoise step with CFG (three branches: rows 3), its
median device time (the program's `engine.denoise_step` spans): the gen
expert's forward over the latent block, B1 at T > 1, the combination."""

from benchmark.harness import spans


def read(run):
    return spans.median_device_ms(run, "engine.denoise_step", rows=3)
