"""The gradient of bagel_tpu_torch's sparse_packed_attention (B3) vs JAX.

`sparse_packed_attention_train` (forward: the plain version on CPU tensors;
backward: the chunked recompute's VJP) against bagel_tpu's `custom_vjp`
through `jax.vjp` (the Pallas forward in interpret mode, the chunked
recompute backward), fp32 on both sides: dq, dk and dv at D = 128 with GQA
and at D = 72 (the SigLIP head), with S a multiple of the backward's chunk
and S not one (JAX then recomputes over all S rows at once, the port in
chunks with a shorter last one: the same VJP); 2e-5.
The kernel's own gradient check runs on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch
from asserts import assert_close_live

import jax
import jax.numpy as jnp

from bagel_tpu.ops import sparse_flash as jsf
from bagel_tpu_torch.ops import sparse_flash as tsf
from test_torch_sparse_flash import _meta, _qkv

TOL = dict(rtol=2e-5, atol=2e-5)


def _jax(q, k, v, ids, block, bwd_chunk, g):
    with jax.default_matmul_precision("float32"):
        out, vjp = jax.vjp(
            lambda q_, k_, v_: jsf.sparse_packed_attention(
                q_, k_, v_, *(jnp.asarray(x) for x in ids), block, block, None, True,
                bwd_chunk),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _torch(q, k, v, ids, bwd_chunk, g):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tsf.sparse_packed_attention_train(qt, kt, vt, *(torch.tensor(x) for x in ids),
                                            bwd_chunk=bwd_chunk)
    out.backward(torch.tensor(g))
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("s,bwd_chunk", [(256, 128), (384, 256)])
@pytest.mark.parametrize("h,kh,d", [(4, 1, 128), (2, 2, 72)])
def test_gradient_matches_jax_custom_vjp(s, bwd_chunk, h, kh, d):
    """(256, 128): the chunk divides S; (384, 256): it does not (JAX
    recomputes over S, the port takes a 128-row last chunk)."""
    rng = np.random.default_rng(s + d)
    q, k, v = _qkv(rng, s, h, kh, d)
    ids = _meta(s, rng, n_docs=3, pad=11)
    g = rng.standard_normal((s, h, d)).astype(np.float32)
    want, want_grads = _jax(q, k, v, ids, 128, bwd_chunk, g)
    before = tsf.sparse_packed_attention.launches
    got, got_grads = _torch(q, k, v, ids, bwd_chunk, g)
    assert tsf.sparse_packed_attention.launches == before  # CPU: no kernel
    assert_close_live(got, want, name="out", **TOL)
    for name, a, b in zip("qkv", got_grads, want_grads):
        assert_close_live(a, b, name=f"d{name}", **TOL)
    pad = ids[0] == 0
    assert np.abs(got_grads[0][pad]).max() == 0.0  # padding queries get no gradient
    # padding keys are never visible: no gradient reaches them either
    assert np.abs(got_grads[1][pad]).max() == 0.0 and np.abs(got_grads[2][pad]).max() == 0.0


def test_forward_equals_forward_only_call_and_ids_get_no_grad():
    s, h, kh, d = 128, 4, 2, 16
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(x) for x in _qkv(rng, s, h, kh, d))
    ids = [torch.tensor(x) for x in _meta(s, rng)]
    fwd = tsf.sparse_packed_attention(q, k, v, *ids)
    with torch.no_grad():
        assert torch.equal(tsf.sparse_packed_attention_train(q, k, v, *ids), fwd)
    qt = q.clone().requires_grad_()
    out = tsf.sparse_packed_attention_train(qt, k, v, *ids)
    assert torch.equal(out.detach(), fwd)
    dq, = torch.autograd.grad(out.sum(), qt)
    assert dq.shape == q.shape and torch.isfinite(dq).all()


def test_raises_on_a_device_without_the_kernel():
    q = torch.zeros(8, 2, 16, device="meta")
    ids = [torch.zeros(8, dtype=torch.int32, device="meta")] * 3
    with pytest.raises(ValueError, match="no kernel"):
        tsf.sparse_packed_attention_train(q, q[:, :1], q[:, :1], *ids)
