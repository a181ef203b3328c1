"""Seeded draws shared by the traffic generators.

Every seed gets the same work in another order. Sizes are stratified: a
block of n requests takes one size from each of n equal steps of the
(log-)range, at an offset within its step that the block's place fixes
(`offset`: a low-discrepancy sequence, not the seed), so the blocks of a
run differ from each other and not from seed to seed; the seed only
shuffles each block and draws the content (characters, pixels, noise).
"""

from __future__ import annotations

import numpy as np

ALPHABET = np.array(list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ .,"))
PHI = (5 ** 0.5 - 1) / 2


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one stream of one seed."""
    return np.random.default_rng([int(seed) % (2**64), stream])


def offset(place: int, k: int = 1) -> float:
    """The place-th point of the golden-ratio sequence (k: a second,
    independent one), in [0, 1)."""
    return (place * PHI * k + 0.5 * (k - 1) * PHI) % 1.0


def stratified_log(lo: float, hi: float, n: int, u: float = 0.5) -> np.ndarray:
    """n sizes log-uniform over [lo, hi], one in each of n equal steps of
    log-size at the fraction u of the step (ascending, integers)."""
    x = (np.arange(n) + u) / n
    return np.rint(np.exp(np.log(lo) + x * (np.log(hi) - np.log(lo)))).astype(np.int64)


def stratified_lin(lo: float, hi: float, n: int, u: float = 0.5) -> np.ndarray:
    return lo + (np.arange(n) + u) / n * (hi - lo)


def text(g: np.random.Generator, n: int) -> str:
    """n characters (one mock-tokenizer token each)."""
    return "".join(ALPHABET[g.integers(0, len(ALPHABET), n)])
