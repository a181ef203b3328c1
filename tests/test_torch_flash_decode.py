"""The decode kernel pair's arithmetic (split-KV over GQA groups) vs bagel_tpu.

`ops.flash.flash_decode_split_plain` repeats, in plain PyTorch, what the
CUDA decode pair of csrc/flash_cached_attention.cu computes at T = 1: the
row's live 64-key tiles shared out over `splits` blocks, each split's
softmax state (m, l, bf16-rounded P times V), then a combine in split order.
It is held against the JAX package's masked attention at a decode step
(`cache_block_mask` + `dot_attention`, fp32), GQA 28/4 at a narrow head
dim, to 1e-5; the kernel itself is held against the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.ops.attention import cache_block_mask, dot_attention
from bagel_tpu_torch.ops import flash as tflash

TOL = dict(rtol=1e-5, atol=1e-5)
H, KH, D, S = 28, 4, 16, 512


def _case(seed, past, valid):
    rng = np.random.default_rng(seed)
    b = len(past)
    q = rng.standard_normal((b, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((b, S, KH, D)).astype(np.float32)
    v = rng.standard_normal((b, S, KH, D)).astype(np.float32)
    return q, k, v, np.asarray(past, np.int32), np.asarray(valid, np.int32)


def _jax(q, k, v, past, valid, causal):
    mask = cache_block_mask(S, 1, jnp.asarray(past), jnp.asarray(valid), causal)
    with jax.default_matmul_precision("float32"):
        return np.asarray(dot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        mask=mask, precision="float32"))


CASES = {
    # label: (past, valid, splits)
    "one split": ([300], [1], 1),
    "3 splits": ([300], [1], 3),
    "32 splits": ([300], [1], 32),
    "more splits than live tiles": ([70], [1], 40),
    "past = 0": ([0], [1], 3),
    "a tile boundary at past + 1": ([255], [1], 3),
    "q_valid = 0 rows": ([100, 40], [0, 1], 5),
    "B = 3, mixed pasts": ([37, 0, 450], [1, 1, 1], 7),
}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("label", list(CASES))
def test_split_plain_matches_jax(label, causal):
    past, valid, splits = CASES[label]
    q, k, v, p, vl = _case(sum(past) + splits, past, valid)
    want = _jax(q, k, v, p, vl, causal)
    args = (torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(p),
            torch.tensor(vl))
    got = tflash.flash_decode_split_plain(*args, splits=splits).numpy()
    assert got.shape == (len(past), 1, H, D)
    np.testing.assert_allclose(got, want, **TOL)
    for row, n in enumerate(valid):
        if n == 0:  # a frozen row gives 0
            assert np.abs(got[row]).max() == 0.0
    # the wrapper at T = 1 on a CPU tensor: the plain version, no launch
    plain = tflash.flash_cached_attention(*args, causal=causal).numpy()
    np.testing.assert_allclose(plain, want, **TOL)
    assert tflash.flash_cached_attention.launches == 0


def test_splits_take_whole_tiles_and_a_dropped_split_shows():
    """Each live split holds whole 64-key tiles in order, empty splits have
    m = -inf and l = 0, and leaving one live split out of the combine moves
    the result far beyond the tolerance (the card's negative control)."""
    q, k, v, p, vl = (torch.tensor(a) for a in _case(9, [300], [1]))
    m, l, acc = tflash.decode_partials_plain(q, k, v, p, vl, 8)
    live = ~torch.isinf(m[0, 0])
    # 301 live keys: 5 tiles over 8 splits, so 3 splits hold none
    assert int(live.sum()) == 5
    assert bool((l[0, :, ~live] == 0).all()) and bool((acc[0, :, ~live] == 0).all())
    full = tflash.decode_combine_plain(m, l, acc, torch.float32)
    gone = int(torch.nonzero(live)[2])
    m2, l2 = m.clone(), l.clone()
    m2[..., gone], l2[..., gone] = float("-inf"), 0.0
    dropped = tflash.decode_combine_plain(m2, l2, acc, torch.float32)
    assert ((dropped - full).norm() / full.norm()).item() > 1e-2
