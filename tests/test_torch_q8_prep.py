"""The int8 attention's quantization (`q8_prep_plain`, the plain version of
the hand-written prep pass) and the kernel's V layout, on the CPU.

- Codes and scales bit-identical to the JAX wrapper's quantization
  (bagel_tpu/ops/flash.py, the int8_compute branch of
  flash_cached_attention, fp32) on every row's live keys, with mixed past,
  a valid = 0 row and stale values past the live end; codes past the live
  end are 0.
- The V^T key permutation, undone, gives the plain layout back bit for bit,
  and it is the fragment mapping that the kernel relies on.
- `flash_q8_plain` over the kernel's layout equals it over the plain one.
The prep kernel is held against `q8_prep_plain` bit for bit on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bagel_tpu_torch.ops import flash as tflash


def _jax_quantize(q, k, v, past_len, q_valid):
    """The JAX wrapper's quantization, expression for expression
    (bagel_tpu/ops/flash.py:351-371, on the [B, heads, N, D] transposes):
    (q8, k8, v8, qs, ks, vs) as numpy, k8/v8 [B, S, KH, D]."""
    qt, kt, vt = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v))
    s = kt.shape[2]
    qa = jnp.max(jnp.abs(qt.astype(jnp.float32)), axis=(2, 3))
    tok_pos = jnp.arange(s)[None, None, :]
    live = tok_pos < (jnp.asarray(past_len) + jnp.asarray(q_valid))[:, None, None]
    ka_tok = jnp.max(jnp.abs(kt.astype(jnp.float32)), axis=3)
    va_tok = jnp.max(jnp.abs(vt.astype(jnp.float32)), axis=3)
    ka = jnp.max(jnp.where(live, ka_tok, 0.0), axis=2)
    va = jnp.max(jnp.where(live, va_tok, 0.0), axis=2)
    qs = jnp.maximum(qa, 1e-12) / 127.0
    ks = jnp.maximum(ka, 1e-12) / 127.0
    vs = jnp.maximum(va, 1e-12) / 127.0

    def to_i8(x, sc):
        xf = x.astype(jnp.float32) / sc[..., None, None]
        return jnp.clip(jnp.round(xf), -127, 127).astype(jnp.int8)

    q8, k8, v8 = to_i8(qt, qs), to_i8(kt, ks), to_i8(vt, vs)
    back = [np.asarray(x).transpose(0, 2, 1, 3) for x in (q8, k8, v8)]
    return (*back, np.asarray(qs), np.asarray(ks), np.asarray(vs))


def _inputs(seed, b, t, s, h, kh, d, past, valid, stale):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32) * 2.0
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v[0, 0, 0, :4] = [0.5, 1.5, -2.5, 127.0]  # ties at .5 once scaled by vs = 1
    for r, (p, n) in enumerate(zip(past, valid)):  # stale contents past the live end
        k[r, p + n:] = stale
        v[r, p + n:] = stale
    return q, k, v, np.asarray(past, np.int32), np.asarray(valid, np.int32)


CASES = [
    # b, t, s, h, kh, d, past, valid
    (3, 20, 96, 28, 4, 32, [17, 0, 60], [20, 13, 0]),  # mixed past, a valid = 0 row
    (2, 33, 80, 4, 2, 16, [40, 5], [33, 30]),          # S not a multiple of 32
]


@pytest.mark.parametrize("stale", [float("nan"), 1e6])
@pytest.mark.parametrize("b,t,s,h,kh,d,past,valid", CASES)
def test_q8_prep_plain_bit_identical_to_jax(b, t, s, h, kh, d, past, valid, stale):
    q, k, v, p, n = _inputs(b + t, b, t, s, h, kh, d, past, valid, stale)
    want = _jax_quantize(q, k, v, p, n)
    q8, k8, v8t, qs, ks, vs = tflash.q8_prep_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(p), torch.tensor(n))
    s32 = -(-s // 32) * 32
    assert v8t.shape == (b, kh, d, s32) and v8t.is_contiguous()
    v8 = tflash.q8_v_rows(v8t, s)
    for got, ref in zip((qs, ks, vs), want[3:]):
        np.testing.assert_array_equal(got.numpy(), ref)  # scales: every bit
    np.testing.assert_array_equal(q8.numpy(), want[0])   # q: every row of the block
    for r in range(b):
        live = p[r] + n[r]
        np.testing.assert_array_equal(k8[r, :live].numpy(), want[1][r, :live])
        np.testing.assert_array_equal(v8[r, :live].numpy(), want[2][r, :live])
        assert not k8[r, live:].any() and not v8[r, live:].any()  # 0 past the live end
    assert not tflash.q8_v_rows(v8t, s32)[:, s:].any()  # keys past S are 0


def test_v_order_is_the_fragment_mapping():
    """Position 16 h + 4 t + e of a 32-key group holds key 16 h + 2 t +
    e % 2 + 8 (e // 2): the key of thread t's e-th accumulator of the group's
    16-key half in wgmma's S fragment, where the 8-bit A fragment of PV
    wants position 4 t + e; each group is a permutation of its own keys."""
    order = tflash.q8_v_order(96)
    for p in range(96):
        g, h, t, e = p // 32, (p // 16) % 2, (p % 16) // 4, p % 4
        assert order[p].item() == 32 * g + 16 * h + 2 * t + e % 2 + 8 * (e // 2)
    for g in range(3):
        assert sorted(order[32 * g: 32 * g + 32].tolist()) == list(range(32 * g, 32 * g + 32))


@pytest.mark.parametrize("s", [32, 70, 256])
def test_v_layout_roundtrip_bit_for_bit(s):
    rng = np.random.default_rng(s)
    v8 = torch.tensor(rng.integers(-127, 128, (2, s, 3, 16)), dtype=torch.int8)
    vt = tflash.q8_v_layout(v8)
    assert vt.shape == (2, 3, 16, -(-s // 32) * 32)
    assert torch.equal(tflash.q8_v_rows(vt, s), v8)
    # a row of V^T is one (batch, head, column) over the permuted keys
    order = tflash.q8_v_order(vt.shape[-1])
    live = order < s
    assert torch.equal(vt[1, 2, 5][live], v8[1, order[live], 2, 5])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_q8_plain_layouts_agree(causal):
    """The plain int8 attention over the kernel's V^T equals its arithmetic
    over V as [B, S, KH, D] (the JAX wrapper's layout), bit for bit, at the
    kernel's key tile and another."""
    q, k, v, p, n = _inputs(7, 2, 40, 200, 8, 2, 32, [30, 150], [40, 33], 0.0)
    args = [torch.tensor(x) for x in (q, k, v, p, n)]
    q8, k8, v8t, qs, ks, vs = tflash.q8_prep_plain(*args)
    v8 = tflash.q8_v_rows(v8t, k8.shape[1])
    for block_k in (tflash.Q8_BLOCK_K, 64):
        kern = tflash.flash_q8_plain(q8, k8, v8t, qs, ks, vs, args[3], args[4], causal=causal,
                                     block_k=block_k, out_dtype=torch.float32)
        rows = tflash._flash_q8_rows(q8, k8, v8, qs, ks, vs, args[3], args[4], causal=causal,
                                     scale=None, block_k=block_k, out_dtype=torch.float32)
        assert torch.equal(kern, rows) and kern.abs().max() > 0


def test_q8_prep_on_cpu_is_the_plain_version():
    q, k, v, p, n = _inputs(9, 2, 12, 64, 4, 2, 16, [3, 40], [12, 9], float("nan"))
    args = [torch.tensor(x) for x in (q, k, v, p, n)]
    before = tflash.q8_prep.launches
    got, want = tflash.q8_prep(*args), tflash.q8_prep_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tflash.q8_prep.launches == before


def test_q8_live_zeroes_only_the_codes_past_the_live_keys():
    """`q8_live` (the comparison of the card's pass with its plain version)
    keeps every code of the live keys and zeroes the rest, in both layouts."""
    q, k, v, p, n = _inputs(11, 2, 10, 70, 4, 2, 16, [30, 5], [10, 7], 0.0)
    args = [torch.tensor(x) for x in (q, k, v, p, n)]
    q8, k8, v8t, *_ = tflash.q8_prep_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(tflash.q8_live(k8, v8t, args[3], args[4]),
                                                 (k8, v8t)))
    junk_k = torch.full_like(k8, 5)
    junk_v = tflash.q8_v_layout(torch.full((2, 70, 2, 16), 5, dtype=torch.int8))
    lk, lv = tflash.q8_live(junk_k, junk_v, args[3], args[4])
    vrows = tflash.q8_v_rows(lv, 70)
    for r, live in enumerate((40, 12)):
        assert (lk[r, :live] == 5).all() and not lk[r, live:].any()
        assert (vrows[r, :live] == 5).all() and not vrows[r, live:].any()
