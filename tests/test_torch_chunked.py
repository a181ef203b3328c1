"""bagel_tpu_torch chunked_packed_attention vs bagel_tpu's (forward and VJP).

Both sides fp32 (JAX under `jax.default_matmul_precision("float32")`) on
random packed ids (documents with causal, full and noise splits, and
trailing padding whose rows see nothing), at several chunk sizes; 1e-5.
"""

import numpy as np
import pytest
import torch
from asserts import assert_close_live

import jax
import jax.numpy as jnp

from bagel_tpu.ops.chunked import chunked_packed_attention as jchunked
from bagel_tpu_torch.ops.attention import dot_attention, mask_to_bias, train_packed_mask
from bagel_tpu_torch.ops.chunked import chunked_packed_attention as tchunked
from bagel_tpu.ops.attention import mask_to_bias as jmask_to_bias
from test_torch_sparse_flash import _meta, _qkv
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_fwd_vjp(q, k, v, ids, chunk, g):
    with jax.default_matmul_precision("float32"):
        out, vjp = jax.vjp(
            lambda q_, k_, v_: jchunked(q_, k_, v_, *(jnp.asarray(x) for x in ids), chunk=chunk),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _torch_fwd_vjp(q, k, v, ids, chunk, g):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tchunked(qt, kt, vt, *(torch.tensor(x) for x in ids), chunk=chunk)
    out.backward(torch.tensor(g))
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("h,kh,d", [(4, 2, 16), (4, 4, 8)])
def test_forward_and_vjp_match_jax(chunk, h, kh, d):
    s = 128
    rng = np.random.default_rng(chunk + h + d)
    q, k, v = _qkv(rng, s, h, kh, d)
    ids = _meta(s, rng, pad=9)
    g = rng.standard_normal((s, h, d)).astype(np.float32)
    want, want_grads = _jax_fwd_vjp(q, k, v, ids, chunk, g)
    got, got_grads = _torch_fwd_vjp(q, k, v, ids, chunk, g)
    assert_close_live(got, want, name="out", **TOL)
    for name, a, b in zip("qkv", got_grads, want_grads):
        assert_close_live(a, b, name=f"d{name}", **TOL)
    # fully masked rows (padding): zero output, zero dq, no NaN anywhere
    pad = ids[0] == 0
    assert pad.any() and np.abs(got[pad]).max() == 0.0
    assert np.abs(got_grads[0][pad]).max() == 0.0
    assert all(np.isfinite(x).all() for x in got_grads)


def test_chunking_does_not_change_the_function():
    """Every chunk size gives the dense-mask attention of the same ids."""
    s, h, kh, d = 96, 4, 2, 8
    rng = np.random.default_rng(7)
    q, k, v = (torch.tensor(x) for x in _qkv(rng, s, h, kh, d))
    ids = [torch.tensor(x) for x in _meta(s, rng, pad=5)]
    dense = dot_attention(q[None], k[None], v[None], mask=train_packed_mask(*ids)[None])[0]
    for chunk in (16, 32, 96):
        torch.testing.assert_close(tchunked(q, k, v, *ids, chunk=chunk), dense,
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="does not divide"):
        tchunked(q, k, v, *ids, chunk=40)


def test_mask_to_bias_matches_jax():
    rng = np.random.default_rng(3)
    ids = _meta(64, rng, pad=4)
    mask = train_packed_mask(*(torch.tensor(x) for x in ids))
    got = mask_to_bias(mask).numpy()
    want = np.asarray(jmask_to_bias(jnp.asarray(mask.numpy())))
    np.testing.assert_array_equal(got, want)
    assert mask_to_bias(mask, torch.bfloat16).dtype == torch.bfloat16
