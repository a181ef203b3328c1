"""bagel_tpu_torch sparse_packed_attention vs bagel_tpu's Pallas kernel.

On CPU tensors the port's wrapper takes its plain version
(`train_packed_mask` + `dot_attention`); it is held against the Pallas
kernel in interpret mode at 2e-5 (both fp32), with padding rows exactly 0,
and `block_liveness`'s integer tables must equal JAX's. The CUDA kernel
itself is held against the plain version in tests/test_torch_cuda.py and
chip_smoke.py, on the card.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bagel_tpu.models.siglip import segment_flash_attention as jsegment_flash
from bagel_tpu.ops import sparse_flash as jsf
from bagel_tpu_torch.models.siglip import segment_flash_attention as tsegment_flash
from bagel_tpu_torch.ops import _build
from bagel_tpu_torch.ops import attention as tattn
from bagel_tpu_torch.ops import sparse_flash as tsf

TOL = dict(rtol=2e-5, atol=2e-5)


def _meta(s, rng, n_docs=3, pad=6):
    """Random packed ids: n_docs documents, each with a causal text split, a
    full (vit) split and a noise (vae) split; `pad` trailing padding rows."""
    doc = np.zeros(s, np.int32)
    fan = np.full(s, -1, np.int32)
    noi = np.full(s, -1, np.int32)
    body = s - pad
    bounds = np.sort(rng.choice(np.arange(1, body), n_docs - 1, replace=False))
    sid = 0
    for d, (a, b) in enumerate(zip(np.r_[0, bounds], np.r_[bounds, body]), start=1):
        doc[a:b] = d
        seg = np.array_split(np.arange(a, b), 3)
        if len(seg[1]):
            fan[seg[1]] = sid
            sid += 1
        if len(seg[2]):
            fan[seg[2]] = sid
            noi[seg[2]] = sid
            sid += 1
    return doc, fan, noi


def _qkv(rng, s, h, kh, d):
    return (rng.standard_normal((s, h, d)).astype(np.float32),
            rng.standard_normal((s, kh, d)).astype(np.float32),
            rng.standard_normal((s, kh, d)).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("h,kh,d", [(4, 2, 16), (4, 4, 72), (4, 1, 128)])
def test_plain_matches_pallas(seed, h, kh, d):
    s = 128
    rng = np.random.default_rng(seed)
    q, k, v = _qkv(rng, s, h, kh, d)
    doc, fan, noi = _meta(s, rng)
    want = jsf.sparse_packed_attention(
        *(jnp.asarray(x) for x in (q, k, v, doc, fan, noi)),
        block_q=16, block_k=16, interpret=True)
    before = tsf.sparse_packed_attention.launches
    got = tsf.sparse_packed_attention(*(torch.tensor(x) for x in (q, k, v, doc, fan, noi)))
    assert tsf.sparse_packed_attention.launches == before  # CPU: the plain version
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert np.abs(got[doc == 0]).max() == 0.0  # padding rows are exactly 0


def test_block_liveness_tables_match_jax():
    rng = np.random.default_rng(2)
    for s, block, n_docs in ((128, 16, 3), (256, 32, 5), (192, 64, 2)):
        doc, fan, noi = _meta(s, rng, n_docs=n_docs, pad=block + 3)
        want_idx, want_cnt = jsf.block_liveness(jnp.asarray(doc), jnp.asarray(fan), block, block)
        got_idx, got_cnt = tsf.block_liveness(torch.tensor(doc), torch.tensor(fan), block, block)
        assert got_idx.dtype == got_cnt.dtype == torch.int32
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
        assert int(got_cnt[-1]) == 0  # the padding-only q block has no live tile


def test_liveness_skips_cross_document_blocks():
    doc = torch.tensor([1] * 32 + [2] * 64 + [0] * 32, dtype=torch.int32)
    fan = torch.full((128,), -1, dtype=torch.int32)
    live_idx, live_cnt = tsf.block_liveness(doc, fan, 16, 16)
    assert int(live_cnt[0]) == 1 and int(live_idx[0, 0]) == 0
    assert int(live_cnt[5]) == 4 and sorted(live_idx[5, :4].tolist()) == [2, 3, 4, 5]
    assert int(live_cnt[7]) == 0


def test_kernel_tables_pad_a_ragged_sequence():
    """At the kernel's tiles (BLOCK_Q query rows, BLOCK_K keys), a ragged S
    is padded with document 0 / fan -1: the tile indices equal JAX's
    block_liveness on the padded ids."""
    s = 3 * tsf.BLOCK_Q - 17
    seg = np.zeros(s, np.int32)
    seg[:70] = 1
    seg[70:150] = 2
    noise = np.full(s, -1, np.int32)
    entries, cnt, _, _ = tsf.kernel_tables(*(torch.tensor(x) for x in (seg, seg, noise)))
    padded = np.zeros(3 * tsf.BLOCK_Q, np.int32)
    padded[:s] = seg
    want_idx, want_cnt = jsf.block_liveness(jnp.asarray(padded), jnp.asarray(padded),
                                            tsf.BLOCK_Q, tsf.BLOCK_K)
    np.testing.assert_array_equal((entries & ~tsf.FULL_TILE).numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    assert int(cnt[2]) == 0  # the last q tile holds padding only


@pytest.mark.parametrize("kind", ["train", "segments"])
def test_full_tile_flags_are_exact_where_set(kind):
    """A tile the kernel's table flags as fully visible has every (query,
    key) pair visible under train_packed_mask; for one image padded to a
    ragged length every tile but those holding padding is flagged."""
    rng = np.random.default_rng(3)
    bq, bk = tsf.BLOCK_Q, tsf.BLOCK_K
    if kind == "train":
        s = 6 * bq
        ids = [torch.tensor(x) for x in _meta(s, rng, n_docs=2, pad=bq + 5)]
    else:
        s = 5 * bq - 20
        seg = torch.zeros(s, dtype=torch.int32)
        seg[: 5 * bq - 40] = 1
        ids = [seg, seg, torch.full_like(seg, -1)]
    entries, cnt, _, _ = tsf.kernel_tables(*ids)
    nq = -(-s // bq)
    mask = torch.zeros(nq * bq, nq * bq, dtype=torch.bool)
    mask[:s, :s] = tattn.train_packed_mask(*ids)
    flagged = 0
    for i in range(nq):
        for e in entries[i, : cnt[i]].tolist():
            tile = mask[i * bq:(i + 1) * bq, (e & ~tsf.FULL_TILE) * bk:]
            if e & tsf.FULL_TILE:
                assert tile[:, :bk].all()
                flagged += 1
    assert flagged > 0
    if kind == "segments":  # q tiles without padding x key tiles without padding
        assert flagged == (nq - 1) * ((5 * bq - 40) // bk)


def test_all_padding_rows_are_zero():
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 32, 2, 2, 8)
    doc = torch.zeros(32, dtype=torch.int32)
    fan = torch.full((32,), -1, dtype=torch.int32)
    out = tsf.sparse_packed_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                      doc, fan, fan)
    assert torch.isfinite(out).all() and out.abs().max() == 0.0


def test_segment_flash_matches_pallas():
    """SigLIP's use: three packed images and 40 padding rows, D=72, against
    the JAX segment_flash_attention in interpret mode (which pads N to 256)."""
    rng = np.random.default_rng(7)
    n, h, d = 640, 4, 72
    seg = np.zeros(n, np.int32)
    seg[:200], seg[200:500], seg[500:600] = 1, 2, 3
    q, k, v = _qkv(rng, n, h, h, d)
    want = jsegment_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
                          interpret=True)
    got = tsegment_flash(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                         torch.tensor(seg)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert np.abs(got[600:]).max() == 0.0


def test_smoke_builds_every_kernel_source():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    assert sorted(chip_smoke.KERNELS) == _build.kernel_names()
    assert "sparse_packed_attention" in _build.kernel_names()


def test_build_all_reports_every_failing_source(tmp_path, monkeypatch):
    """One nvcc per source, started together; every failure is reported,
    and no partial library is left behind."""
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho \"error: refused $*\" >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    names = _build.kernel_names()
    with pytest.raises(_build.KernelBuildError) as err:
        _build.build_all(names)
    for name in names:
        assert f"{name}: nvcc exited 2" in str(err.value)
    assert list((tmp_path / "build").iterdir()) == []


def test_build_all_keeps_the_ptxas_report_beside_the_library(tmp_path, monkeypatch):
    """A library built before reports the registers and spills of its own
    build, read back from beside it, without running nvcc again."""
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text(
        "#!/bin/sh\n"
        "while [ \"$1\" != -o ]; do shift; done; touch \"$2\"\n"
        "echo \"ptxas info    : Used 42 registers, 0 bytes spill stores\" >&2\n"
    )
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    names = _build.kernel_names()
    first = _build.build_all(names)
    fake.write_text("#!/bin/sh\nexit 3\n")  # a second compile would fail
    again = _build.build_all(names)
    for name in names:
        assert "Used 42 registers" in first[name]
        assert again[name] == first[name]
        assert _build.library_path(name).is_file()


def test_wrapper_checks_refuse_what_the_kernel_does_not_take():
    """The checks the CUDA path runs before it passes pointers: bf16, a
    head dim the kernel instantiates, 16-byte rows, GQA shapes, int32 ids,
    and tables of the right shape."""
    s, h, d = 100, 4, 72
    q = torch.zeros(s, h, d, dtype=torch.bfloat16)
    kv = torch.zeros(s, 2, d, dtype=torch.bfloat16)
    seg = torch.ones(s, dtype=torch.int32)
    ids = dict(document_id=seg, fan_id=seg, noise_id=seg)
    tsf._check(q, kv, kv, ids)  # accepted
    with pytest.raises(TypeError, match="bf16"):
        tsf._check(q.float(), kv, kv, ids)
    with pytest.raises(ValueError, match="D in"):
        tsf._check(q[..., :64], kv[..., :64], kv[..., :64], ids)
    with pytest.raises(ValueError, match="16-byte rows"):
        tsf._check(torch.zeros(s, h, d + 4, dtype=torch.bfloat16)[..., 2:74], kv, kv, ids)
    with pytest.raises(ValueError, match="GQA"):
        tsf._check(q, torch.zeros(s, 3, d, dtype=torch.bfloat16),
                   torch.zeros(s, 3, d, dtype=torch.bfloat16), ids)
    with pytest.raises(ValueError, match="int32"):
        tsf._check(q, kv, kv, dict(ids, noise_id=seg.long()))
    tables = tsf.kernel_tables(seg, seg, -seg)
    tsf._check_tables(tables, s, q.device)  # accepted
    with pytest.raises(ValueError, match="tables"):
        big = torch.ones(2 * tsf.BLOCK_Q, dtype=torch.int32)  # tables of another tile count
        tsf._check_tables(tsf.kernel_tables(big, big, -big), s, q.device)
