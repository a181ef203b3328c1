"""The traced image's VAE decode, its device time (the program's
`engine.vae_decode` span)."""

from benchmark.harness import spans


def read(run):
    ms = spans.device_ms(run, "engine.vae_decode")
    return None if ms is None else sum(ms)
