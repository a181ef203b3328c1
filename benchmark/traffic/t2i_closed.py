"""Text-to-image requests for a closed loop of one client.

Parameters (the mix's file): `prompt_tokens` [lo, hi] (one mock token a
character, log-uniform), `block` (requests a stratified block: every
block holds the same set of prompt lengths in the seed's order),
`requests` (the pool a run draws from, in order), and the sampling
settings every request carries (`px`, `num_timesteps`, `cfg_text_scale`,
`cfg_img_scale`, `cfg_interval`, `timestep_shift`, `cfg_renorm_type`).
Each request has its own noise seed.
"""

from __future__ import annotations

from benchmark.harness.draws import rng, stratified_log, text


def draw(p: dict, seed: int) -> list:
    g = rng(seed, 1)
    out = []
    for start in range(0, p["requests"], p["block"]):
        lens = stratified_log(*p["prompt_tokens"], p["block"])
        g.shuffle(lens)
        for n in lens[: p["requests"] - start]:
            out.append({"id": len(out), "prompt": text(g, int(n)),
                        "noise_seed": int(g.integers(0, 2**62))})
    return out


def sampling(p: dict) -> dict:
    """The `BagelEngine.__call__` keyword arguments every request carries."""
    return dict(num_timesteps=p["num_timesteps"], cfg_text_scale=p["cfg_text_scale"],
                cfg_img_scale=p["cfg_img_scale"], cfg_interval=tuple(p["cfg_interval"]),
                timestep_shift=p["timestep_shift"], cfg_renorm_type=p["cfg_renorm_type"],
                image_shapes=(p["px"], p["px"]))
