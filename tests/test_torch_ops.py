"""bagel_tpu_torch ops vs bagel_tpu ops on the same numpy inputs (CPU, fp32).

Bar: 1e-5, the ops tolerance of the JAX package's own parity tests.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.ops import attention as jattn
from bagel_tpu.ops import embeds as jemb
from bagel_tpu.ops import norms as jnorms
from bagel_tpu.ops import rope as jrope
from bagel_tpu_torch.ops import attention as tattn
from bagel_tpu_torch.ops import embeds as temb
from bagel_tpu_torch.ops import norms as tnorms
from bagel_tpu_torch.ops import rope as trope

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_rms_and_layer_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tnorms.rms_norm(torch.tensor(x), torch.tensor(w), 1e-6)),
        np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), **TOL)
    np.testing.assert_allclose(
        _np(tnorms.layer_norm(torch.tensor(x), torch.tensor(w), torch.tensor(b))),
        np.asarray(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))),
        **TOL)


def test_rms_norm_bf16_casts_before_weight():
    """bf16 input: the normalized value rounds to bf16 before the fp32
    weight multiply, and the output keeps the input dtype."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    got = tnorms.rms_norm(torch.tensor(x).bfloat16(), torch.tensor(w))
    want = jnorms.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got.float()), np.asarray(want, np.float32))


def test_group_norm_nhwc():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    b = (0.1 * rng.standard_normal(64)).astype(np.float32)
    got = tnorms.group_norm(torch.tensor(x), torch.tensor(w), torch.tensor(b))
    want = jnorms.group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_rope():
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    q = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 32)).astype(np.float32)
    np.testing.assert_allclose(
        _np(trope.rope_inv_freq(32, 1e6)), np.asarray(jrope.rope_inv_freq(32, 1e6)), **TOL)
    tc, ts = trope.rope_cos_sin(torch.tensor(pos), 32, 10000.0)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 32, 10000.0)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), **TOL)
    np.testing.assert_allclose(_np(ts), np.asarray(js), **TOL)
    tq, tk = trope.apply_rope(torch.tensor(q), torch.tensor(k), tc, ts)
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    np.testing.assert_allclose(_np(tq), np.asarray(jq), **TOL)
    np.testing.assert_allclose(_np(tk), np.asarray(jk), **TOL)
    np.testing.assert_array_equal(
        _np(trope.rotate_half(torch.tensor(q))), np.asarray(jrope.rotate_half(jnp.asarray(q))))


def test_embeds():
    np.testing.assert_allclose(
        _np(temb.sincos_2d_grid(64, 8)), np.asarray(jemb.sincos_2d_grid(64, 8)), **TOL)
    pos = np.arange(10, dtype=np.float32) * 1.5
    np.testing.assert_allclose(
        _np(temb.sincos_1d(32, torch.tensor(pos))),
        np.asarray(jemb.sincos_1d(32, jnp.asarray(pos))), **TOL)
    t = np.asarray([0.0, 0.25, 0.5, 0.999], np.float32)
    for dim in (256, 7):
        np.testing.assert_allclose(
            _np(temb.timestep_embedding(torch.tensor(t), dim)),
            np.asarray(jemb.timestep_embedding(jnp.asarray(t), dim)), **TOL)
    for fn in ("flattened_position_ids_extrapolate", "flattened_position_ids_interpolate"):
        np.testing.assert_array_equal(
            getattr(temb, fn)(64, 48, 8, 16), getattr(jemb, fn)(64, 48, 8, 16))


@pytest.mark.parametrize("causal", [True, False])
def test_cache_block_mask_and_dot_attention(causal):
    rng = np.random.default_rng(4)
    b, t, s, h, kh, d = 2, 8, 24, 4, 2, 16
    past = np.asarray([5, 0], np.int32)
    valid = np.asarray([8, 3], np.int32)  # row 1 has padded queries
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)

    tmask = tattn.cache_block_mask(s, t, torch.tensor(past), torch.tensor(valid), causal)
    jmask = jattn.cache_block_mask(s, t, jnp.asarray(past), jnp.asarray(valid), causal)
    np.testing.assert_array_equal(_np(tmask), np.asarray(jmask))

    got = tattn.dot_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), tmask)
    want = jattn.dot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask,
                               precision="float32")
    got = _np(got)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # all-masked rows (padded queries) give 0, not NaN
    assert np.isfinite(got).all()
    assert np.abs(got[1, 3:]).max() == 0.0


def test_dot_attention_2d_mask_and_scale():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 6, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 6, 1, 8)).astype(np.float32)
    v = rng.standard_normal((1, 6, 1, 8)).astype(np.float32)
    mask = np.tril(np.ones((6, 6), bool))
    mask[2] = False  # one row sees nothing
    got = tattn.dot_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                              torch.tensor(mask), scale=0.3)
    want = jattn.dot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), scale=0.3, precision="float32")
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert np.abs(_np(got)[0, 2]).max() == 0.0
