"""bagel_tpu_torch's int8 attention (B2's plain version, and the q8 prep
in the wrapper) vs bagel_tpu's Pallas `flash_cached_attention(...,
int8_compute=True)` in interpret mode, at the same key tile.

Bar: each output row within 2e-5 of the row's largest |value|, apart from
rows where an int8 code of P flipped by one step (p * 127 / row_m within
float rounding of a half: the two sides compute exp in different
libraries). Those rows are counted (at most 1% of the rows) and each stays
within two code steps, 2 max|v| / 127. The CUDA kernel is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bagel_tpu.ops import flash as jflash
from bagel_tpu_torch.ops import flash as tflash
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

REL = 2e-5


def _inputs(seed, b, t, s, h, kh, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kh, d)).astype(np.float32),
            rng.standard_normal((b, s, kh, d)).astype(np.float32))


def _both(q, k, v, past, valid, causal, block_k):
    want = jflash.flash_cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(past), jnp.asarray(valid),
        causal=causal, block_k=block_k, interpret=True, int8_compute=True)
    got = tflash.flash_cached_attention_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(past),
        torch.tensor(valid), causal=causal, int8_compute=True, block_k=block_k)
    return got.numpy(), np.asarray(want)


def _assert_rows_close(got, want, v, past, valid):
    vmax = max(np.abs(v[r, : p + n]).max() for r, (p, n) in enumerate(zip(past, valid)))
    scale = np.abs(want).max(axis=-1, keepdims=True) + 1e-30
    row_err = (np.abs(got - want) / scale).max(axis=-1)  # [B, T, H]
    flipped = row_err > REL
    assert flipped.mean() <= 0.01, f"{flipped.sum()} of {flipped.size} rows differ"
    assert np.abs(got - want)[flipped].max(initial=0.0) <= 2 * vmax / 127
    return int(flipped.sum())


CASES = [
    # b, t, s, h, kh, d, past, valid, block_k
    (2, 40, 256, 4, 2, 32, [30, 100], [40, 33], 64),    # ragged T < 128, GQA
    (2, 40, 256, 4, 2, 32, [30, 100], [40, 33], 128),
    (1, 300, 512, 4, 1, 32, [64], [300], 64),           # T >= 128 ragged: JAX pads to 512
    (1, 300, 512, 4, 1, 32, [64], [300], 256),
    (3, 64, 256, 8, 2, 64, [0, 17, 120], [64, 50, 1], 64),  # no cache; a 1-token row
    (2, 40, 256, 28, 4, 32, [30, 100], [40, 33], 128),  # GQA 28/4 at the kernel's tile
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t,s,h,kh,d,past,valid,block_k", CASES)
def test_plain_matches_pallas_int8(b, t, s, h, kh, d, past, valid, block_k, causal):
    q, k, v = _inputs(b + t + block_k, b, t, s, h, kh, d)
    past, valid = np.asarray(past, np.int32), np.asarray(valid, np.int32)
    got, want = _both(q, k, v, past, valid, causal, block_k)
    assert got.shape == want.shape == q.shape
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    _assert_rows_close(got, want, v, past, valid)
    for row in range(b):  # rows past valid are exactly 0
        assert np.abs(got[row, valid[row]:]).max(initial=0.0) == 0.0


def test_result_depends_on_the_key_tile():
    """row_m is a max over one key tile, so the tile size shows in the
    result: the plain version must take it, not ignore it."""
    q, k, v = _inputs(3, 1, 32, 512, 2, 2, 32)
    args = [torch.tensor(a) for a in (q, k, v)] + [torch.tensor([200], dtype=torch.int32),
                                                   torch.tensor([32], dtype=torch.int32)]
    o64 = tflash.flash_cached_attention_plain(*args, causal=True, int8_compute=True, block_k=64)
    o256 = tflash.flash_cached_attention_plain(*args, causal=True, int8_compute=True,
                                               block_k=256)
    assert not torch.equal(o64, o256)


@pytest.mark.parametrize("garbage", [float("nan"), 1e6])
def test_stale_dead_tail_changes_nothing(garbage):
    b, t, s, h, kh, d = 2, 24, 256, 4, 2, 32
    q, k, v = _inputs(4, b, t, s, h, kh, d)
    past, valid = np.asarray([50, 10], np.int32), np.asarray([24, 20], np.int32)
    clean, want = _both(q, k, v, past, valid, True, 64)
    for r, (p, n) in enumerate(zip(past, valid)):
        k[r, p + n:] = garbage
        v[r, p + n:] = garbage
    dirty, want_dirty = _both(q, k, v, past, valid, True, 64)
    np.testing.assert_array_equal(dirty, clean)  # the dead tail is out of the scales
    assert np.isfinite(want_dirty).all()
    _assert_rows_close(dirty, want_dirty, np.nan_to_num(v), past, valid)


def test_q8_prep_scopes():
    """q's absmax covers every row of the block (invalid rows too); k/v's
    only each batch row's live prefix; codes round half to even; k/v codes
    span the buffer, 0 past each row's live prefix, V in the kernel's
    transposed layout."""
    q = torch.zeros((2, 4, 1, 8))
    q[0, 3, 0, 0] = 5.0  # an invalid row still sets q's scale
    q[1, 0, 0, 0] = 2.0
    k = torch.zeros((2, 16, 1, 8))
    k[0, :6] = 1.0
    k[0, 10] = 100.0  # dead for row 0 (live prefix 6)
    k[1, 9] = 3.0  # live for row 1 (live prefix 10)
    past = torch.tensor([2, 7], dtype=torch.int32)
    valid = torch.tensor([4, 3], dtype=torch.int32)
    q8, k8, v8, qs, ks, vs = tflash.q8_prep(q, k, k, past, valid)
    assert qs[0, 0].item() == np.float32(5.0) / np.float32(127.0)
    assert ks[0, 0].item() == np.float32(1.0) / np.float32(127.0)
    assert ks[1, 0].item() == np.float32(3.0) / np.float32(127.0)
    assert k8.shape[1] == 16  # the buffer, not the longest live prefix (no host read)
    assert not k8[0, 6:].any() and not k8[1, 10:].any()  # 0 past the live prefix
    assert v8.shape == (2, 1, 8, 32)  # [B, KH, D, S rounded up to 32]
    assert q8[0, 3, 0, 0].item() == 127 and k8[1, 9, 0, 0].item() == 127


def test_wrapper_int8_on_cpu_is_the_plain_version_at_the_kernel_tile(monkeypatch):
    q, k, v = _inputs(5, 1, 20, 256, 4, 2, 32)
    args = [torch.tensor(a) for a in (q, k, v)] + [torch.tensor([70], dtype=torch.int32),
                                                   torch.tensor([20], dtype=torch.int32)]
    want = tflash.flash_cached_attention_plain(*args, causal=True, int8_compute=True,
                                               block_k=tflash.Q8_BLOCK_K)
    assert torch.equal(tflash.flash_cached_attention(*args, causal=True, int8_compute=True),
                       want)
    monkeypatch.setenv("BAGEL_FLASH_INT8", "1")  # read at call time
    assert tflash.default_int8()
    assert torch.equal(tflash.flash_cached_attention(*args, causal=True), want)
    monkeypatch.setenv("BAGEL_FLASH_INT8", "0")
    assert not torch.equal(tflash.flash_cached_attention(*args, causal=True), want)
    assert tflash.flash_cached_attention_q8.launches == 0
