"""B3's backward (the port's kernel gradient) on the CPU: its plain twin.

On CPU tensors `sparse_packed_attention_bwd` runs
`sparse_packed_attention_bwd_plain`, the backward kernels' formulas in
plain PyTorch, fed the logsumexp that the forward's plain version returns.
Held here, fp32 on both sides (JAX under float32 matmul precision, the
Pallas forward in interpret mode):
- the plain forward's lse against jax.nn.logsumexp of JAX's masked logits
  (`bagel_tpu.ops.attention.train_packed_mask`), 1e-5; rows with no
  visible key hold the sentinel +inf;
- the twin's dq, dk, dv against jax.vjp of bagel_tpu's
  sparse_packed_attention (its custom_vjp: XLA's chunked recompute), 2e-5,
  at D = 128 with GQA and at D = 72, S a multiple of the chunk and not,
  S not a multiple of the kernel's 128-row tile, with noise splits that
  hide keys from later text and padding;
- the transposed tables (each key tile's live query tiles) against the
  transpose of the live matrix rebuilt from JAX's block_liveness, each
  FULL_TILE flag equal to full_tiles;
- NaN in padding rows (q, k, v and the output's gradient) leaves every
  gradient bit-equal.
The kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 10).
"""

import numpy as np
import pytest
import torch
from asserts import assert_close_live

import jax
import jax.numpy as jnp

from bagel_tpu.ops import sparse_flash as jsf
from bagel_tpu.ops.attention import train_packed_mask as jtrain_packed_mask
from bagel_tpu_torch.ops import sparse_flash as tsf
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

TOL = dict(rtol=2e-5, atol=2e-5)
LSE_TOL = dict(rtol=1e-5, atol=1e-5)


def _ids(s, rng, pad):
    """Packed ids over s tokens, `pad` padding rows at the end: two
    documents, each causal text, a full split, a noise split, text after
    it (which must not see that noise split's keys) and a second noise
    split; split boundaries drawn from rng."""
    doc = np.zeros(s, np.int32)
    fan = np.full(s, -1, np.int32)
    noi = np.full(s, -1, np.int32)
    body = s - pad
    cut = int(rng.integers(body // 3, 2 * body // 3))
    sid = 0
    for d, (a, b) in enumerate(((0, cut), (cut, body)), start=1):
        doc[a:b] = d
        parts = np.array_split(np.arange(a, b), 5)  # text, full, noise, text, noise
        for kind, part in zip(("text", "full", "noise", "text", "noise"), parts):
            if kind == "text" or not len(part):
                continue
            fan[part] = sid
            if kind == "noise":
                noi[part] = sid
            sid += 1
    return doc, fan, noi


def _qkv(rng, s, h, kh, d):
    return (rng.standard_normal((s, h, d)).astype(np.float32),
            rng.standard_normal((s, kh, d)).astype(np.float32),
            rng.standard_normal((s, kh, d)).astype(np.float32))


def _jax_lse(q, k, ids, scale):
    """jax.nn.logsumexp of JAX's masked logits: [H, S]."""
    h, kh = q.shape[1], k.shape[1]
    mask = jtrain_packed_mask(*(jnp.asarray(x) for x in ids))
    with jax.default_matmul_precision("float32"):
        kk = jnp.repeat(jnp.asarray(k), h // kh, axis=1)
        logits = jnp.einsum("qhd,khd->hqk", jnp.asarray(q), kk) * scale
        lse = jax.nn.logsumexp(jnp.where(mask[None], logits, -jnp.inf), axis=-1)
    return np.asarray(lse), np.asarray(mask).any(axis=1)


@pytest.mark.parametrize("h,kh,d", [(4, 1, 128), (2, 2, 72)])
def test_plain_lse_matches_jax_logsumexp(h, kh, d):
    rng = np.random.default_rng(d)
    s = 320
    q, k, v = _qkv(rng, s, h, kh, d)
    ids = _ids(s, rng, pad=9)
    want, seen = _jax_lse(q, k, ids, d**-0.5)
    out, lse, _ = tsf.sparse_packed_attention(*(torch.tensor(x) for x in (q, k, v, *ids)),
                                              for_backward=True)
    lse = lse.numpy()
    assert lse.shape == (h, s) and lse.dtype == np.float32
    assert not seen[ids[0] == 0].any() and seen[ids[0] != 0].all()
    np.testing.assert_allclose(lse[:, seen], want[:, seen], **LSE_TOL)
    assert np.isposinf(lse[:, ~seen]).all()  # the sentinel: no visible key
    # the output is the forward-only call's
    plain = tsf.sparse_packed_attention(*(torch.tensor(x) for x in (q, k, v, *ids)))
    assert torch.equal(out, plain)


def _jax_grads(q, k, v, ids, block, bwd_chunk, g):
    with jax.default_matmul_precision("float32"):
        _, vjp = jax.vjp(
            lambda q_, k_, v_: jsf.sparse_packed_attention(
                q_, k_, v_, *(jnp.asarray(x) for x in ids), block, block, None, True,
                bwd_chunk),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("s,block,chunk", [(256, 128, 128), (384, 128, 256), (320, 64, 128)])
@pytest.mark.parametrize("h,kh,d", [(4, 1, 128), (2, 2, 72)])
def test_twin_matches_jax_vjp(s, block, chunk, h, kh, d):
    """(256, 128): the chunk divides S; (384, 256): it does not; (320, 64):
    S is not a multiple of the kernel's 128-row tile either."""
    rng = np.random.default_rng(s + d)
    q, k, v = _qkv(rng, s, h, kh, d)
    ids = _ids(s, rng, pad=13)
    g = rng.standard_normal((s, h, d)).astype(np.float32)
    want = _jax_grads(q, k, v, ids, block, chunk, g)
    qt, kt, vt, gt = (torch.tensor(x) for x in (q, k, v, g))
    idt = tuple(torch.tensor(x) for x in ids)
    out, lse, out_lo = tsf.sparse_packed_attention(qt, kt, vt, *idt, for_backward=True)
    before = tsf.sparse_packed_attention_bwd.launches
    got = tsf.sparse_packed_attention_bwd(qt, kt, vt, out, lse, gt, idt, chunk=chunk,
                                          out_lo=out_lo)
    assert tsf.sparse_packed_attention_bwd.launches == before  # CPU: the plain twin
    for name, a, b in zip("qkv", got, want):
        assert_close_live(a.numpy(), b, name=f"d{name}", **TOL)
    pad = ids[0] == 0
    for t in got:  # padding rows take part in no pair
        assert t.numpy()[pad].max() == 0.0 and t.numpy()[pad].min() == 0.0


def test_noise_predicate_reaches_the_gradient():
    """Anti-vacuity: the ids hide keys from later text (noise of another
    split), and dropping that predicate moves the gradient."""
    rng = np.random.default_rng(7)
    s, h, kh, d = 256, 2, 1, 128
    q, k, v = (torch.tensor(x) for x in _qkv(rng, s, h, kh, d))
    ids = tuple(torch.tensor(x) for x in _ids(s, rng, pad=5))
    g = torch.tensor(rng.standard_normal((s, h, d)).astype(np.float32))

    def grads(meta):
        out, lse, out_lo = tsf.sparse_packed_attention(q, k, v, *meta, for_backward=True)
        return tsf.sparse_packed_attention_bwd(q, k, v, out, lse, g, meta, out_lo=out_lo)

    blind = grads((ids[0], ids[1], torch.full_like(ids[2], -1)))
    for a, b in zip(grads(ids), blind):
        assert (a - b).abs().max() > 1e-2


@pytest.mark.parametrize("ragged", [False, True])
def test_transposed_tables_match_jax_liveness(ragged):
    rng = np.random.default_rng(11)
    n = 6
    s = n * tsf.BLOCK_Q - (37 if ragged else 0)
    doc, fan, noi = _ids(s, rng, pad=150)
    # a second layout with many fully visible tiles: three images
    seg = np.zeros(s, np.int32)
    seg[:300], seg[300:700], seg[700:s - 20] = 1, 2, 3
    flagged = []
    for ids in ((doc, fan, noi), (seg, seg, np.full(s, -1, np.int32))):
        tables = tsf.kernel_tables(*(torch.tensor(x) for x in ids))
        padded = [np.pad(x, (0, n * tsf.BLOCK_Q - s), constant_values=c)
                  for x, c in zip(ids, (0, -1, -1))]
        live_idx, live_cnt = (np.asarray(x) for x in jsf.block_liveness(
            jnp.asarray(padded[0]), jnp.asarray(padded[1]), tsf.BLOCK_Q, tsf.BLOCK_K))
        live = np.zeros((n, n), bool)
        for i in range(n):
            live[i, live_idx[i, :live_cnt[i]]] = True
        full = tsf.full_tiles(*(torch.tensor(x) for x in padded), tsf.BLOCK_Q,
                              tsf.BLOCK_K).numpy()
        t_entries, t_counts = tables.t_entries.numpy(), tables.t_counts.numpy()
        np.testing.assert_array_equal(t_counts, live.T.sum(axis=1))
        flagged.append(0)
        for kt in range(n):
            listed = t_entries[kt, :t_counts[kt]]
            tiles = listed & ~tsf.FULL_TILE
            np.testing.assert_array_equal(tiles, np.flatnonzero(live[:, kt]))  # ascending
            np.testing.assert_array_equal((listed & tsf.FULL_TILE) != 0, full[tiles, kt])
            flagged[-1] += int(full[tiles, kt].sum())
        # the forward's direction is unchanged: block_liveness with the same flags
        np.testing.assert_array_equal(tables.entries.numpy() & ~tsf.FULL_TILE, live_idx)
        np.testing.assert_array_equal(tables.counts.numpy(), live_cnt)
    assert flagged[1] > 0  # the images' tiles away from the padding are fully visible


@pytest.mark.parametrize("h,kh,d", [(4, 2, 128), (2, 2, 72)])
def test_nan_in_padding_rows_leaves_the_gradient_bit_equal(h, kh, d):
    rng = np.random.default_rng(3)
    s = 300
    ids = tuple(torch.tensor(x) for x in _ids(s, rng, pad=40))
    q, k, v = (torch.tensor(x) for x in _qkv(rng, s, h, kh, d))
    g = torch.tensor(rng.standard_normal((s, h, d)).astype(np.float32))

    def grads(q, k, v, g):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = tsf.sparse_packed_attention_train(*leaves, *ids, bwd_chunk=128)
        return torch.autograd.grad(out, leaves, g)

    clean = grads(q, k, v, g)
    dead = ids[0] == 0
    stale = [t.clone() for t in (q, k, v, g)]
    for t in stale:
        t[dead] = float("nan")
    again = grads(*stale)
    assert all(torch.isfinite(t).all() for t in clean)
    assert all(torch.equal(a, b) for a, b in zip(again, clean))


def test_expanded_output_gradient():
    """autograd may hand the backward an expanded gradient (out.sum()): the
    same gradients as the materialized one."""
    rng = np.random.default_rng(4)
    s, h, kh, d = 200, 2, 1, 72
    ids = tuple(torch.tensor(x) for x in _ids(s, rng, pad=8))
    qkv = [torch.tensor(x, requires_grad=True) for x in _qkv(rng, s, h, kh, d)]
    out = tsf.sparse_packed_attention_train(*qkv, *ids)
    expanded = torch.autograd.grad(out.sum(), qkv)
    dense = torch.autograd.grad(tsf.sparse_packed_attention_train(*qkv, *ids), qkv,
                                torch.ones(s, h, d))
    assert all(torch.equal(a, b) for a, b in zip(expanded, dense))
    assert all(t.abs().max() > 0 for t in expanded)


def test_backward_raises_on_a_device_without_the_kernel():
    q = torch.zeros(8, 2, 72, device="meta")
    ids = tuple(torch.zeros(8, dtype=torch.int32, device="meta") for _ in range(3))
    lse = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tsf.sparse_packed_attention_bwd(q, q[:, :1], q[:, :1], q, lse, q, ids, out_lo=q)
