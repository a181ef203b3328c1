"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from bagel_tpu_torch.ops import flash
from bagel_tpu_torch.ops import sparse_flash
from bagel_tpu_torch.utils.cuda_graph import kernels_on_card


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain_on_card(causal):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, t, s, h, kh, d = 3, 130, 512, 28, 4, 128
    q = torch.randn((b, t, h, d), generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, s, kh, d), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, s, kh, d), generator=gen, device="cuda").bfloat16()
    past = torch.tensor([70, 0, 300], dtype=torch.int32, device="cuda")
    valid = torch.tensor([130, 97, 130], dtype=torch.int32, device="cuda")
    before = flash.flash_cached_attention.launches
    got = flash.flash_cached_attention(q, k, v, past, valid, causal=causal)
    torch.cuda.synchronize()
    assert flash.flash_cached_attention.launches == before + 1
    want = flash.flash_cached_attention_plain(q, k, v, past, valid, causal=causal)
    # bf16 output rounding plus bf16 P in the PV product: 2-4 ulp of a value,
    # a tenth of the row's rms near 0, 1% in norm
    for row, n in enumerate(valid.tolist()):
        g, w = got[row, :n].float(), want[row, :n].float()
        d = (g - w).abs()
        assert (d <= 2.0 ** -6 * w.abs() + 0.1 * w.pow(2).mean().sqrt()).all()
        assert d.norm() <= 1e-2 * w.norm()
    assert got[1, 97:].abs().max().item() == 0.0


def _segments(lens, s):
    ids = torch.zeros(s, dtype=torch.int32, device="cuda")
    start = 0
    for i, n in enumerate(lens, start=1):
        ids[start:start + n] = i
        start += n
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("h,kh,d,train,strided", [(16, 16, 72, False, False),
                                                  (16, 16, 72, False, True),
                                                  (28, 4, 128, True, False)])
def test_sparse_kernel_matches_plain_on_card(h, kh, d, train, strided):
    """B3 at SigLIP's head dim (three packed images and a padded tail),
    also on q/k/v views of one fused projection as the tower hands them in,
    and at the LLM's training shape (GQA 28/4 under the full causal + fan +
    noise predicate); S is ragged (not a multiple of either tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(1)
    s = 1001
    doc = _segments([300, 250, 400], s)
    if train:
        fan = torch.full((s,), -1, dtype=torch.int32, device="cuda")
        noise = fan.clone()
        fan[100:200], fan[200:300], noise[200:300] = 0, 1, 1
        fan[550:700], fan[700:950], noise[700:950] = 2, 3, 3
    else:
        fan, noise = doc, torch.full_like(doc, -1)
    if strided:  # views of one [s, (h + 2 kh) d] projection, strides ((h + 2 kh) d, d, 1)
        qkv = torch.randn((s, (h + 2 * kh) * d), generator=gen, device="cuda").bfloat16()
        q, k, v = (t.view(s, -1, d) for t in qkv.split([h * d, kh * d, kh * d], dim=1))
    else:
        q = torch.randn((s, h, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((s, kh, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((s, kh, d), generator=gen, device="cuda").bfloat16()
    before = sparse_flash.sparse_packed_attention.launches
    got = sparse_flash.sparse_packed_attention(q, k, v, doc, fan, noise)
    torch.cuda.synchronize()
    assert sparse_flash.sparse_packed_attention.launches == before + 1
    want = sparse_flash.sparse_packed_attention_plain(q, k, v, doc, fan, noise)
    rows = doc != 0
    g, w = got[rows].float(), want[rows].float()
    err = (g - w).abs()
    # the same gate as B1's: 2-4 bf16 ulp of a value, a tenth of the rms
    # near 0, 1% in norm
    assert (err <= 2.0 ** -6 * w.abs() + 0.1 * w.pow(2).mean().sqrt()).all()
    assert err.norm() <= 1e-2 * w.norm()
    assert got[~rows].abs().max().item() == 0.0
    k[~rows] = float("nan")  # stale NaN in keys no query can see
    v[~rows] = float("nan")
    assert torch.equal(sparse_flash.sparse_packed_attention(q, k, v, doc, fan, noise), got)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bias", [(300, 1040, 528, True), (1, 3584, 512, False),
                                        (130, 18944, 3584, False)])
def test_int8_matmul_bit_identical_on_card(m, k, n, bias):
    """B5 equals its plain version bit for bit (exact int32 sums, the same
    f32 epilogue), at ragged M/N/K and the down projection's K, on a k-major
    weight made by the load-time helper."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from bagel_tpu_torch.ops import int8_matmul as m8
    from bagel_tpu_torch.utils.quant import to_kmajor

    gen = torch.Generator(device="cuda").manual_seed(2)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    wq = to_kmajor(torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                                 dtype=torch.int8))
    xs = (torch.rand((m, 1), generator=gen, device="cuda") + 0.5) / 127
    ws = (torch.rand((n,), generator=gen, device="cuda") + 0.5) / 127
    b = torch.randn((n,), generator=gen, device="cuda").bfloat16() if bias else None
    before = m8.int8_matmul.launches
    got = m8.int8_matmul(xq, xs, wq, ws, b)
    torch.cuda.synchronize()
    assert m8.int8_matmul.launches == before + 1
    assert torch.equal(got, m8.int8_matmul_plain(xq, xs, wq, ws, b))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 3584, 512), (3, 18944, 3584), (64, 3584, 4608)])
def test_int4_matmul_matches_plain_on_card(m, k, n):
    """B4 within one bf16 ulp of its plain version, plus the f32 sums' own
    error bound (K 2^-24 sum |x w|: the two add the same products in
    another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from bagel_tpu_torch.ops import int4_matmul as m4
    from bagel_tpu_torch.utils.quant import dequantize_weight4, quantize_weight_int4

    gen = torch.Generator(device="cuda").manual_seed(3)
    leaf = quantize_weight_int4(torch.randn((k, n), generator=gen, device="cuda") * 0.02)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    before = m4.int4_matmul.launches
    got = m4.int4_matmul(x, leaf["w_p4"], leaf["scale4"]).float()
    torch.cuda.synchronize()
    assert m4.int4_matmul.launches == before + 1
    want = m4.int4_matmul_plain(x, leaf["w_p4"], leaf["scale4"]).float()
    w = dequantize_weight4(leaf, torch.bfloat16).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -126))) - 7)
    assert ((got - want).abs() <= ulp + k * 2.0 ** -24 * (x.float().abs() @ w.abs())).all()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 3584, 3584), (3, 18944, 3584), (1, 128, 528 * 256)])
def test_int4_matmul_deterministic_with_fused_bias_on_card(m, k, n):
    """B4 gives the same bits on two calls (the partial sums of a split K
    are added in split order by whichever block arrives last) where K is
    split and where it is not (one scale group), its fused bias epilogue
    equals the unbiased output followed by JAX's rounding, bf16(f32(out) +
    f32(b)), for bf16 and f32 biases, and a biased call runs one kernel on
    the card (the kernel nodes of one call captured in a CUDA graph)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from bagel_tpu_torch.ops import int4_matmul as m4
    from bagel_tpu_torch.utils.quant import quantize_weight_int4

    assert (m4.grid(k, n, m) < k // 2) == (n != 528 * 256)  # K split, or not
    gen = torch.Generator(device="cuda").manual_seed(5)
    leaf = quantize_weight_int4(torch.randn((k, n), generator=gen, device="cuda") * 0.02)
    x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    first = m4.int4_matmul(x, leaf["w_p4"], leaf["scale4"])
    again = m4.int4_matmul(x, leaf["w_p4"], leaf["scale4"])
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    for dtype in (torch.bfloat16, torch.float32):
        b = torch.randn((n,), generator=gen, device="cuda").to(dtype)
        before = m4.int4_matmul.launches
        got = m4.int4_matmul(x, leaf["w_p4"], leaf["scale4"], b)
        torch.cuda.synchronize()
        assert m4.int4_matmul.launches == before + 1
        assert torch.equal(got, (first.float() + b.float()).bfloat16())
    names = kernels_on_card(lambda: m4.int4_matmul(x, leaf["w_p4"], leaf["scale4"], b))
    assert len(names) == 1 and "int4_matmul_kernel" in names[0], names


@pytest.mark.cuda
def test_int4_matmul_workspace_and_graph_capture_on_card():
    """B4's workspace (the split sums and the arrival counters) is made
    outside CUDA-graph capture: a device's first call inside capture is
    refused. Once it exists, a shape first seen inside capture replays
    right, and eager calls after the replay give the same bits (the
    counters are back at 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from bagel_tpu_torch.ops import int4_matmul as m4
    from bagel_tpu_torch.utils.quant import dequantize_weight4, quantize_weight_int4

    gen = torch.Generator(device="cuda").manual_seed(6)
    k, n = 3584, 1536  # a shape no other test uses: K split over 168 blocks
    leaf = quantize_weight_int4(torch.randn((k, n), generator=gen, device="cuda") * 0.02)
    x = torch.randn((1, k), generator=gen, device="cuda").bfloat16()
    assert m4.grid(k, n) < k // 2
    m4._workspace.pop(torch.cuda.current_device(), None)
    m4._grids.pop((k, n, 1), None)
    with pytest.raises(RuntimeError, match="workspace"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            m4.int4_matmul(x, leaf["w_p4"], leaf["scale4"])
    small = quantize_weight_int4(torch.randn((256, 512), generator=gen, device="cuda"))
    m4.int4_matmul(x[:, :256], small["w_p4"], small["scale4"])  # makes the workspace
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = m4.int4_matmul(x, leaf["w_p4"], leaf["scale4"])
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    eager = [m4.int4_matmul(x, leaf["w_p4"], leaf["scale4"]) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(captured, eager[0]) and torch.equal(eager[0], eager[1])
    want = m4.int4_matmul_plain(x, leaf["w_p4"], leaf["scale4"]).float()
    w = dequantize_weight4(leaf, torch.bfloat16).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=2.0 ** -126))) - 7)
    assert ((captured.float() - want).abs() <= ulp + k * 2.0 ** -24 * (x.float().abs() @ w.abs())).all()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_q8_matches_plain_on_card(causal):
    """B2 against its plain version at the kernel's key tile, under B1's
    gate; rows past valid exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(4)
    b, t, s, h, kh, d = 3, 130, 512, 28, 4, 128
    q = torch.randn((b, t, h, d), generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, s, kh, d), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, s, kh, d), generator=gen, device="cuda").bfloat16()
    past = torch.tensor([70, 0, 300], dtype=torch.int32, device="cuda")
    valid = torch.tensor([130, 97, 130], dtype=torch.int32, device="cuda")
    prep = flash.q8_prep(q, k, v, past, valid)
    before = flash.flash_cached_attention_q8.launches
    got = flash.flash_cached_attention_q8(*prep, past, valid, causal=causal)
    torch.cuda.synchronize()
    assert flash.flash_cached_attention_q8.launches == before + 1
    want = flash.flash_q8_plain(*prep, past, valid, causal=causal)
    for row, n in enumerate(valid.tolist()):
        g, w = got[row, :n].float(), want[row, :n].float()
        err = (g - w).abs()
        assert (err <= 2.0 ** -6 * w.abs() + 0.1 * w.pow(2).mean().sqrt()).all()
        assert err.norm() <= 1e-2 * w.norm()
    assert got[1, 97:].abs().max().item() == 0.0


def _decode_inputs(gen, past, valid, s=1024, h=28, kh=4, nan_beyond=True):
    b = len(past)
    q = torch.randn((b, 1, h, 128), generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, s, kh, 128), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, s, kh, 128), generator=gen, device="cuda").bfloat16()
    if nan_beyond:  # stale values past each row's live keys
        for row, p in enumerate(past):
            k[row, p + 1:] = float("nan")
            v[row, p + 1:] = float("nan")
    return (q, k, v, torch.tensor(past, dtype=torch.int32, device="cuda"),
            torch.tensor(valid, dtype=torch.int32, device="cuda"))


def _assert_attention_gate(got, want, valid):
    for row, n in enumerate(valid):
        if n == 0:
            assert got[row].abs().max().item() == 0.0
            continue
        g, w = got[row].float(), want[row].float()
        err = (g - w).abs()
        assert (err <= 2.0 ** -6 * w.abs() + 0.1 * w.pow(2).mean().sqrt()).all()
        assert err.norm() <= 1e-2 * w.norm()


@pytest.mark.cuda
@pytest.mark.parametrize("past,valid", [([0], [1]), ([63], [1]), ([4975], [1]),
                                        ([37, 900, 0], [1, 0, 1])])
def test_decode_pair_matches_plain_on_card(past, valid):
    """B1 at T = 1 (the split-KV pair) against its plain version under B1's
    gate, with stale NaN past the live keys; one call counts once, and runs
    two kernels; captured in a CUDA graph it replays the eager bits, and an
    eager call on a shape first seen after the capture is right too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(7)
    s = 8192 if max(past) > 1000 else 1024
    args = _decode_inputs(gen, past, valid, s)
    before = flash.flash_cached_attention.launches
    got = flash.flash_cached_attention(*args, causal=True)
    torch.cuda.synchronize()
    assert flash.flash_cached_attention.launches == before + 1
    q, k, v, p, vl = args
    clean = [t.nan_to_num(0.0) for t in (k, v)]  # the plain version multiplies 0 x NaN
    want = flash.flash_cached_attention_plain(q, *clean, p, vl, causal=True)
    _assert_attention_gate(got, want, valid)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flash.flash_cached_attention(*args, causal=True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, got)
    fresh = _decode_inputs(gen, [p_ + 7 for p_ in past], valid, s)
    again = flash.flash_cached_attention(*fresh, causal=False)
    want2 = flash.flash_cached_attention_plain(fresh[0], *(t.nan_to_num(0.0) for t in fresh[1:3]),
                                               *fresh[3:], causal=False)
    torch.cuda.synchronize()
    _assert_attention_gate(again, want2, valid)


@pytest.mark.cuda
def test_decode_pair_is_two_kernels_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    args = _decode_inputs(torch.Generator(device="cuda").manual_seed(8), [500], [1])
    names = kernels_on_card(lambda: flash.flash_cached_attention(*args, causal=True))
    assert len(names) == 2 and "split" in names[0] and "combine" in names[1], names


@pytest.mark.cuda
def test_int8_matmul_refuses_a_row_major_weight_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from bagel_tpu_torch.ops import int8_matmul as m8

    xq = torch.zeros((4, 64), dtype=torch.int8, device="cuda")
    wq = torch.zeros((64, 32), dtype=torch.int8, device="cuda")
    before = m8.int8_matmul.launches
    with pytest.raises(ValueError, match="w8a8_kmajor"):
        m8.int8_matmul(xq, torch.ones((4, 1), device="cuda"), wq, torch.ones(32, device="cuda"))
    assert m8.int8_matmul.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(1, 3584), (77, 1040), (300, 18944)])
def test_quantize_rows_bit_identical_on_card(m, k):
    """The quantization pass gives the plain version's codes and scales bit
    for bit (IEEE division, round half to even), on a row of zeros, rows
    with ties at .5 and bf16 rows of mixed magnitude; on a strided view."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from bagel_tpu_torch.ops import int8_matmul as m8

    gen = torch.Generator(device="cuda").manual_seed(9)
    base = torch.randn((m, k + 64), generator=gen, device="cuda")
    base *= torch.rand((m, 1), generator=gen, device="cuda") * 50
    x = base.bfloat16()[:, 64:]  # a view: row stride k + 64
    if m > 2:
        x[1] = 0.0
        x[2] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5],
                            device="cuda").repeat(k // 8).bfloat16()
    before = m8.quantize_rows.launches
    xq, xs = m8.quantize_rows(x)
    torch.cuda.synchronize()
    assert m8.quantize_rows.launches == before + 1
    want_q, want_s = m8.quantize_rows_plain(x)
    assert torch.equal(xq, want_q) and torch.equal(xs, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(1, 1792), (8, 4736), (77, 1040)])
def test_split_row_quantization_bit_identical_on_card(m, k):
    """The reduce-only and given-scale passes give the plain version's
    absmax and codes bit for bit, on a strided view; B5's f32 instance the
    plain epilogue before its rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from bagel_tpu_torch.ops import int8_matmul as m8
    from bagel_tpu_torch.utils.quant import to_kmajor

    gen = torch.Generator(device="cuda").manual_seed(10)
    base = torch.randn((m, k + 64), generator=gen, device="cuda")
    x = (base * torch.rand((m, 1), generator=gen, device="cuda") * 50).bfloat16()[:, 64:]
    before = m8.row_absmax.launches, m8.quantize_rows_given.launches
    amax = m8.row_absmax(x)
    scale = m8.row_scale(amax * 2)  # the other ranks' slices: a larger absmax
    xq, xs = m8.quantize_rows(x, scale)
    torch.cuda.synchronize()
    assert (m8.row_absmax.launches, m8.quantize_rows_given.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    assert torch.equal(amax, m8.row_absmax_plain(x))
    assert xs is scale and torch.equal(xq, m8.quantize_rows_plain(x, scale)[0])
    wq = to_kmajor(torch.randint(-127, 128, (k, 256), generator=gen, device="cuda",
                                 dtype=torch.int8))
    ws = (torch.rand((256,), generator=gen, device="cuda") + 0.5) / 127
    n0 = m8.int8_matmul_f32.launches
    got = m8.int8_matmul(xq, xs, wq, ws, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and m8.int8_matmul_f32.launches == n0 + 1
    assert torch.equal(got, m8.int8_matmul_plain(xq, xs, wq, ws, out_dtype=torch.float32))


def _block_inputs(gen, b, t, s, past, valid, h=28, kh=4, strided_q=False):
    """q [B, T, H, 128] (a view of a fused [B, T, (H + 2 KH) 128] projection
    with strided_q) and k/v [B, S, KH, 128] with NaN past each row's live
    keys (the buffer's stale contents)."""
    d = 128
    if strided_q:
        fused = torch.randn((b, t, (h + 2 * kh) * d), generator=gen, device="cuda").bfloat16()
        q = fused[..., : h * d].view(b, t, h, d)
    else:
        q = torch.randn((b, t, h, d), generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, s, kh, d), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, s, kh, d), generator=gen, device="cuda").bfloat16()
    for row, (p, n) in enumerate(zip(past, valid)):
        k[row, p + n:] = float("nan")
        v[row, p + n:] = float("nan")
    return (q, k, v, torch.tensor(past, dtype=torch.int32, device="cuda"),
            torch.tensor(valid, dtype=torch.int32, device="cuda"))


def _assert_block_gate(got, want, valid):
    """B1's gate over each row's valid rows; rows past valid exactly 0."""
    for row, n in enumerate(valid):
        tail = got[row, n:]
        assert tail.numel() == 0 or tail.abs().max().item() == 0.0
        if n:
            g, w = got[row, :n].float(), want[row, :n].float()
            err = (g - w).abs()
            assert (err <= 2.0 ** -6 * w.abs() + 0.1 * w.pow(2).mean().sqrt()).all()
            assert err.norm() <= 1e-2 * w.norm()


BLOCK_CASES = [
    # b, t, s, past, valid, strided_q
    (2, 300, 1024, [200, 37], [300, 250], False),  # causal diagonal at past > 0, ragged T
    (3, 130, 512, [70, 0, 300], [130, 97, 1], True),  # strided q, a one-row block, T = 128 + 2
    (1, 260, 8192, [4000], [257], False),  # a partial last live tile deep in a long buffer
]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t,s,past,valid,strided_q", BLOCK_CASES)
def test_block_kernel_edges_and_graph_on_card(b, t, s, past, valid, strided_q, causal):
    """B1 at T > 1 (TMA + wgmma) against its plain version: a causal tile
    diagonal at past > 0, a partial last live tile with NaN past the live
    bound, a ragged T and a strided q; captured in a CUDA graph, its replay
    gives the eager bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(10)
    q, k, v, p, n = _block_inputs(gen, b, t, s, past, valid, strided_q=strided_q)
    before = flash.flash_cached_attention.launches
    got = flash.flash_cached_attention(q, k, v, p, n, causal=causal)
    torch.cuda.synchronize()
    assert flash.flash_cached_attention.launches == before + 1
    assert bool(torch.isfinite(got).all())
    clean = [x.nan_to_num(0.0) for x in (k, v)]  # the plain version multiplies 0 x NaN
    want = flash.flash_cached_attention_plain(q, *clean, p, n, causal=causal)
    _assert_block_gate(got, want, valid)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flash.flash_cached_attention(q, k, v, p, n, causal=causal)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, got)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,past,valid,strided_q", BLOCK_CASES)
def test_q8_prep_bit_identical_and_graph_on_card(b, t, s, past, valid, strided_q):
    """The prep pass gives `q8_prep_plain`'s codes, V^T layout and scales bit
    for bit on every row's live keys (the codes past them are unspecified:
    `q8_live` zeroes them, as the plain version writes them), whatever the
    stale keys hold; it counts one launch a call, and replays in a CUDA
    graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(11)
    args = _block_inputs(gen, b, t, s, past, valid, strided_q=strided_q)
    before = flash.q8_prep.launches
    got = flash.q8_prep(*args)
    torch.cuda.synchronize()
    assert flash.q8_prep.launches == before + 1
    want = flash.q8_prep_plain(*args)
    p, n = args[3], args[4]

    def live(prep):
        q8, k8, v8t, qs, ks, vs = prep
        return (q8, *flash.q8_live(k8, v8t, p, n), qs, ks, vs)

    for name, g, w in zip(("q8", "k8", "v8t", "qs", "ks", "vs"), live(got), want):
        assert g.shape == w.shape and torch.equal(g, w), name
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flash.q8_prep(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(c, w) for c, w in zip(live(captured), want))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t,s,past,valid,strided_q", BLOCK_CASES)
def test_flash_q8_kernel_tile_and_graph_on_card(b, t, s, past, valid, strided_q, causal):
    """B2 (integer wgmma) against `flash_q8_plain` at the kernel's key tile
    (Q8_BLOCK_K = 128) on the prep's codes, stale NaN in the bf16 buffer;
    the whole int8 attention (prep + kernel) captured in a CUDA graph
    replays the eager bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(12)
    args = _block_inputs(gen, b, t, s, past, valid, strided_q=strided_q)
    q, k, v, p, n = args
    prep = flash.q8_prep(*args)
    got = flash.flash_cached_attention_q8(*prep, p, n, causal=causal)
    want = flash.flash_q8_plain(*prep, p, n, causal=causal, block_k=flash.Q8_BLOCK_K)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _assert_block_gate(got, want, valid)
    eager = flash.flash_cached_attention(q, k, v, p, n, causal=causal, int8_compute=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flash.flash_cached_attention(q, k, v, p, n, causal=causal, int8_compute=True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(eager, got) and torch.equal(captured, got)


@pytest.mark.cuda
def test_block_kernel_at_the_edit_denoise_on_card():
    """B1 at an edit's denoise shape: three CFG rows of one 3723-token gen
    block (a 976 px latent grid) over very unequal pasts (the cond context
    with the VAE and ViT blocks, cfg_text without the instruction, cfg_img
    with the instruction alone), NaN past each row's live end; the plain
    version row by row (its fp32 scores of all three rows at once would
    take ~16 GB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(13)
    t, past = 3723, [8543, 8486, 57]
    # the forward's buffer: the live prefix of the stacked caches
    q, k, v, p, n = _block_inputs(gen, 3, t, max(past) + t, past, [t] * 3)
    got = flash.flash_cached_attention(q, k, v, p, n, causal=False)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    clean = [x.nan_to_num(0.0) for x in (k, v)]
    want = torch.cat([
        flash.flash_cached_attention_plain(q[r:r + 1], clean[0][r:r + 1], clean[1][r:r + 1],
                                           p[r:r + 1], n[r:r + 1], causal=False)
        for r in range(3)])
    _assert_block_gate(got, want, [t] * 3)


@pytest.mark.cuda
def test_vae_encode_on_card_matches_cpu():
    """The fp32 conv encoder (BAGEL's VAE widths, TF32 off) on the card
    against the same call on the CPU: the posterior mean, within 1e-4 of
    its scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from bagel_tpu_torch.configs import VAEConfig
    from bagel_tpu_torch.models import vae

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = VAEConfig()
        params = vae.init_vae_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        images = torch.rand((1, 64, 48, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
        want = vae.vae_encode(params, cfg, images, sample=False)
        got = vae.vae_encode(_to_cuda(params), cfg, images.cuda(), sample=False).cpu()
        assert got.shape == want.shape == (1, 8, 6, cfg.z_channels)
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("past,valid", [([0], [1]), ([63], [1]), ([4975], [1]),
                                        ([50, 4000, 0, 1200, 63, 64, 2047, 700],
                                         [1, 1, 1, 0, 1, 1, 1, 1])])
def test_decode_kv8_matches_plain_on_card(past, valid):
    """B1-kv8 (the decode pair over int8 codes and f32 scales) against its
    plain twin under B1's gate, with NaN scales and random codes past every
    live end; bit-identical to the bf16 pair on the dequantized view (the
    split kernel dequantizes as `kv_dequantize` does); one call counts
    once, its capture into a CUDA graph none; the graph replays it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, s, h, kh = len(past), 8192 if max(past) > 1000 else 1024, 28, 4
    q = torch.randn((b, 1, h, 128), generator=gen, device="cuda").bfloat16()
    k8, v8 = (torch.randint(-127, 128, (b, s, kh, 128), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, s, kh), generator=gen, device="cuda") * 0.05 for _ in range(2))
    for row, p in enumerate(past):
        ks[row, p + 1:] = float("nan")
        vs[row, p + 1:] = float("nan")
    pl = torch.tensor(past, dtype=torch.int32, device="cuda")
    vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
    before = flash.flash_decode_kv8.launches
    got = flash.flash_decode_kv8(q, k8, v8, ks, vs, pl, vl)
    torch.cuda.synchronize()
    assert flash.flash_decode_kv8.launches == before + 1
    assert bool(torch.isfinite(got).all())
    _assert_attention_gate(got, flash.flash_decode_kv8_plain(q, k8, v8, ks, vs, pl, vl), valid)
    kd, vd = flash.kv8_live(k8, v8, ks, vs, pl, vl)
    pair = torch.empty_like(q)  # B1's bf16 pair at B1-kv8's splits: the same arithmetic
    assert flash._decode(flash._library(), q, kd, vd, pair, pl, vl, 128**-0.5,
                         torch.cuda.current_stream().cuda_stream,
                         flash.kv8_splits(b, kh, q.device)) == 0
    assert torch.equal(got, pair)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flash.flash_decode_kv8(q, k8, v8, ks, vs, pl, vl)
    assert flash.flash_decode_kv8.launches == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, got)


@pytest.mark.cuda
def test_runtime_chat_on_card():
    """In-process ServingRuntime chats on the card over an int8 slot cache
    (tiny widths, head dim 128 for the kernels): every prefill block ran B1
    and every decode forward B1-kv8, once a layer (the forwards the decode
    program's graphs replayed, counted from their nodes, and one warm-up
    step a capture), and the stats count the answers' tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from bagel_tpu_torch.configs import tiny_bagel, tiny_qwen2
    from bagel_tpu_torch.data.tokenizer import MockTokenizer
    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.models.bagel import init_bagel_params
    from bagel_tpu_torch.serving.runtime import ServingRuntime

    cfg = tiny_bagel(llm=tiny_qwen2(hidden_size=512, num_attention_heads=4,
                                    num_key_value_heads=2))
    params = init_bagel_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                               torch.bfloat16, device="cuda")
    tok = MockTokenizer(cfg.llm.vocab_size)
    engine = BagelEngine(params, cfg, tok, tok.new_token_ids, max_kv=512, device="cuda",
                         kv_quant=True)
    from bagel_tpu_torch.inference import decode_program

    rt = ServingRuntime(engine, slots=2, decode_chunk=4, max_new_default=8)
    b1, kv8 = flash.flash_cached_attention.launches, flash.flash_decode_kv8.launches
    decode_program.replayed_kernels.clear()
    rt.start()
    try:
        answers = [rt.submit_chat(p).result(timeout=300) for p in ("hello there", "why?")]
    finally:
        rt.stop()
    assert all(isinstance(a, str) for a in answers)
    assert rt.stats["chat_done"] == 2
    assert rt.stats["tokens_out"] == sum(len(a.split()) for a in answers)
    L = cfg.llm.num_hidden_layers
    assert flash.flash_cached_attention.launches - b1 == L * rt.stats["prefill_blocks"]
    assert decode_program.replayed_launches(flash.flash_cached_attention) == 0
    kv8 = flash.flash_decode_kv8.launches - kv8
    replayed = decode_program.replayed_launches(flash.flash_decode_kv8)
    assert replayed > 0 and rt.decode.captures == 1
    assert kv8 + replayed == L * (rt.stats["decode_forwards"] + rt.decode.captures)


def _card_engine(kv_quant):
    """A tiny engine on the card whose head dim (128) the kernels take."""
    from bagel_tpu_torch.configs import tiny_bagel, tiny_qwen2
    from bagel_tpu_torch.data.tokenizer import MockTokenizer
    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.models.bagel import init_bagel_params

    cfg = tiny_bagel(llm=tiny_qwen2(hidden_size=512, num_attention_heads=4,
                                    num_key_value_heads=2))
    params = init_bagel_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                               torch.bfloat16, device="cuda")
    tok = MockTokenizer(cfg.llm.vocab_size)
    return BagelEngine(params, cfg, tok, tok.new_token_ids, max_kv=512, device="cuda",
                       kv_quant=kv_quant)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_program_matches_eager_on_card(kv_quant, monkeypatch):
    """The decode program's CUDA graphs against the same steps run eagerly
    (graph=False): identical greedy tokens and lengths for a 3-row decode
    with a frozen row (chunks of 5 over 12 steps), a speculative decode and
    tokens sampled from one seed; the kernel's launches, eager and replayed
    (read from the graph's nodes), are L a step and L for the warm-up step
    of a capture; no replay syncs with the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from bagel_tpu_torch.inference import decode_program, speculative
    from bagel_tpu_torch.inference.decode_program import DecodeProgram
    from bagel_tpu_torch.models import qwen2

    engine = _card_engine(kv_quant)
    cfg, llm, L = engine.cfg.llm, engine.params["llm"], engine.cfg.llm.num_hidden_layers
    real = DecodeProgram._replay

    def strict(self, e):
        torch.cuda.set_sync_debug_mode("error")
        try:
            real(self, e)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(DecodeProgram, "_replay", strict)
    cache = engine.decode.owned_cache(cfg, 3, engine.max_kv, engine.kv_dtype, "cuda")
    cache = engine._text_rows(cache, {0: list(range(3, 40)), 1: list(range(5, 20)),
                                      2: list(range(7, 60))}, {0: 0, 1: 0, 2: 0})
    start = torch.tensor([1, 2, 3], device="cuda")
    pos = torch.tensor([37, 15, 53], dtype=torch.int32, device="cuda")
    counted = flash.flash_decode_kv8 if kv_quant else flash.flash_cached_attention
    runs = {}
    for graph in (True, False):
        prog, stats = DecodeProgram(chunk=5), {}
        before = counted.launches
        decode_program.replayed_kernels.clear()
        toks, out = qwen2.decode_text(llm, cfg, cache, start, pos, max_steps=12, eos_id=-1,
                                      active=torch.tensor([True, False, True], device="cuda"),
                                      program=prog, graph=graph, stats=stats)
        eager = counted.launches - before
        replayed = decode_program.replayed_launches(counted)
        assert prog.replays == (3 if graph else 0) and prog.captures == (1 if graph else 0)
        assert stats["forwards"] == 15
        assert (eager, replayed) == ((L, L * 15) if graph else (L * 15, 0))
        spec, sout = speculative.decode_text_spec(
            llm, cfg, cache, start, pos, torch.arange(60, device="cuda").repeat(3, 1),
            pos.long(), max_steps=12, eos_id=-1, draft_len=3, program=prog, graph=graph)
        sampled, _ = qwen2.decode_text(llm, cfg, cache, start, pos, max_steps=8, eos_id=-1,
                                       do_sample=True, temperature=1.5, program=prog,
                                       graph=graph,
                                       generator=torch.Generator(device="cuda").manual_seed(4))
        runs[graph] = (toks, out.length, spec, sout.length, sampled)
    for a, b in zip(runs[True], runs[False]):
        assert torch.equal(a, b)


def _train_ids(s):
    """Three documents with causal text, full and noise splits (text after a
    noise split in the second), then padding."""
    doc = _segments([s // 3, s // 3, s // 3 - 40], s)
    fan = torch.full((s,), -1, dtype=torch.int32, device="cuda")
    noise = fan.clone()
    third = s // 3
    for sid, (a, b, is_noise) in enumerate(((50, 150, False), (150, third, True),
                                            (third + 20, third + 120, True),
                                            (third + 200, 2 * third, False))):
        fan[a:b] = sid
        if is_noise:
            noise[a:b] = sid
    return doc, fan, noise


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,kh,d", [(1024, 28, 4, 128), (700, 16, 16, 72)])
def test_sparse_gradient_matches_plain_on_card(s, h, kh, d):
    """B3's autograd Function on the card: the forward launches the kernel
    and equals the forward-only call bit for bit, the backward launches the
    backward kernels; dq, dk, dv within the kernel gate of the plain
    version's autograd; stale NaN in padding rows changes no gradient; the
    noise predicate dropped fails the gate. S=700 is ragged (no multiple of
    the kernels' 128-row tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((s, h, d), generator=gen, device="cuda").bfloat16()
    k = torch.randn((s, kh, d), generator=gen, device="cuda").bfloat16()
    v = torch.randn((s, kh, d), generator=gen, device="cuda").bfloat16()
    g = torch.randn((s, h, d), generator=gen, device="cuda").bfloat16()
    ids = _train_ids(s)

    def grads(fn, qkv, meta=ids):
        leaves = [t.detach().clone().requires_grad_() for t in qkv]
        out = fn(*leaves, *meta)
        return out.detach(), torch.autograd.grad(out, leaves, g)

    def within(got, want):
        rows = ids[0] != 0
        ok = True
        for a, b in zip(got, want):
            a, b = a[rows].float(), b[rows].float()
            err = (a - b).abs()
            ok &= bool((err <= 2.0 ** -6 * b.abs() + 0.1 * b.pow(2).mean().sqrt()).all())
            ok &= bool(err.norm() <= 1e-2 * b.norm())
        return ok

    before = sparse_flash.sparse_packed_attention.launches
    before_bwd = sparse_flash.sparse_packed_attention_bwd.launches
    out, got = grads(sparse_flash.sparse_packed_attention_train, (q, k, v))
    assert sparse_flash.sparse_packed_attention.launches == before + 1
    assert sparse_flash.sparse_packed_attention_bwd.launches == before_bwd + 1
    assert torch.equal(out, sparse_flash.sparse_packed_attention(q, k, v, *ids))
    _, want = grads(sparse_flash.sparse_packed_attention_plain, (q, k, v))
    assert within(got, want)
    stale = [t.clone() for t in (q, k, v)]
    for t in stale:
        t[ids[0] == 0] = float("nan")
    _, again = grads(sparse_flash.sparse_packed_attention_train, stale)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    _, blind = grads(sparse_flash.sparse_packed_attention_train, (q, k, v),
                     (ids[0], ids[1], torch.full_like(ids[2], -1)))
    assert not within(blind, want)


def _within(got, want, rows):
    """B3's gate for each of dq, dk, dv over the rows that see a key."""
    ok = True
    for a, b in zip(got, want):
        a, b = a[rows].float(), b[rows].float()
        err = (a - b).abs()
        ok &= bool((err <= 2.0 ** -6 * b.abs() + 0.1 * b.pow(2).mean().sqrt()).all())
        ok &= bool(err.norm() <= 1e-2 * b.norm())
    return ok


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,kh,d,kind,strided", [(1001, 28, 4, 128, "train", False),
                                                   (333, 4, 4, 72, "segments", True),
                                                   (1000, 16, 16, 72, "segments", False),
                                                   (768, 4, 4, 72, "gap", False)])
def test_sparse_backward_kernels_match_their_twin_on_card(s, h, kh, d, kind, strided):
    """The backward kernels against their plain twin fed the kernel
    forward's own lse and residual, under B3's gate: the training predicate
    at GQA 28/4, q/k/v views of one fused projection at a ragged S, packed
    images with padding, and a query tile with no live key tile. The
    forward's output is the same bits with lse and the residual stored; the
    kernels are deterministic; stale NaN in padding rows (q, k, v, dO)
    changes nothing; an expanded dO (one contiguous copy) gives the same
    bits; lse + 1 fails the gate."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(2)
    if kind == "train":
        ids = _train_ids(s)
    elif kind == "gap":  # q tile 2 (rows 256..383) is all padding
        seg = _segments([256], s)
        seg[384:] = 2
        ids = (seg, seg, torch.full_like(seg, -1))
    else:
        seg = _segments([200, 100] if s < 500 else [300, 250, 400], s)
        ids = (seg, seg, torch.full_like(seg, -1))
    if strided:
        qkv = torch.randn((s, (h + 2 * kh) * d), generator=gen, device="cuda").bfloat16()
        q, k, v = (t.view(s, -1, d) for t in qkv.split([h * d, kh * d, kh * d], dim=1))
    else:
        q, k, v = (torch.randn((s, n, d), generator=gen, device="cuda").bfloat16()
                   for n in (h, kh, kh))
    g = torch.randn((s, h, d), generator=gen, device="cuda").bfloat16()
    out, lse, out_lo = sparse_flash.sparse_packed_attention(q, k, v, *ids, for_backward=True)
    assert torch.equal(out, sparse_flash.sparse_packed_attention(q, k, v, *ids))
    _, plain_lse, _ = sparse_flash.sparse_packed_attention_plain(q, k, v, *ids,
                                                                 for_backward=True)
    seen = torch.isfinite(plain_lse)
    assert (lse[seen] - plain_lse[seen]).abs().max().item() <= 1e-4
    assert torch.isposinf(lse[~seen]).all()

    def bwd(q=q, k=k, v=v, out=out, lse=lse, g=g, out_lo=out_lo):
        return sparse_flash.sparse_packed_attention_bwd(q, k, v, out, lse, g, ids,
                                                        out_lo=out_lo)

    before = sparse_flash.sparse_packed_attention_bwd.launches
    got = bwd()
    torch.cuda.synchronize()
    assert sparse_flash.sparse_packed_attention_bwd.launches == before + 1
    twin = sparse_flash.sparse_packed_attention_bwd_plain(q, k, v, out, lse, g, ids, d**-0.5,
                                                          out_lo=out_lo)
    rows = ids[0] != 0
    assert _within(got, twin, rows)
    assert all(t[~rows].abs().max().item() == 0.0 for t in got if (~rows).any())
    assert all(torch.equal(a, b) for a, b in zip(bwd(), got))
    stale = [t.clone() for t in (q, k, v, g)]
    for t in stale:
        t[~rows] = float("nan")
    nq, nk, nv, ng = stale
    o2, l2, r2 = sparse_flash.sparse_packed_attention(nq, nk, nv, *ids, for_backward=True)
    assert all(torch.equal(a, b) for a, b in zip(bwd(nq, nk, nv, o2, l2, ng, r2), got))
    ones = torch.ones((), device="cuda", dtype=torch.bfloat16).expand(s, h, d)
    assert all(torch.equal(a, b) for a, b in zip(bwd(g=ones), bwd(g=ones.contiguous())))
    assert not _within(bwd(lse=lse + 1), twin, rows)


@pytest.mark.cuda
def test_sparse_gradient_refuses_what_the_kernel_cannot_take_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    q = torch.zeros((256, 4, 64), device="cuda", dtype=torch.bfloat16, requires_grad=True)
    ids = [torch.ones(256, dtype=torch.int32, device="cuda")] * 3
    with pytest.raises(ValueError, match="D in"):
        sparse_flash.sparse_packed_attention_train(q, q, q, *ids)
    q32 = torch.zeros((256, 4, 128), device="cuda", requires_grad=True)
    with pytest.raises(TypeError, match="bf16"):
        sparse_flash.sparse_packed_attention_train(q32, q32, q32, *ids)
    qb = torch.zeros((256, 4, 128), device="cuda", dtype=torch.bfloat16)
    out, lse, lo = sparse_flash.sparse_packed_attention(qb, qb, qb, *ids, for_backward=True)
    with pytest.raises(TypeError, match="bf16"):
        sparse_flash.sparse_packed_attention_bwd(qb, qb, qb, out, lse, out.float(), tuple(ids),
                                                 out_lo=lo)
    with pytest.raises(ValueError, match="lse"):
        sparse_flash.sparse_packed_attention_bwd(qb, qb, qb, out, lse.T, out, tuple(ids),
                                                 out_lo=lo)


@pytest.mark.cuda
def test_train_step_on_card():
    """A micro model's train step on the card under bf16 autocast through
    --sparse_block: B3 launches 2 x layers (forward and remat recompute)
    plus one a SigLIP layer; the loss is finite and falls on a fixed batch;
    optimizer and EMA offload to pinned host memory give the same
    parameters bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    import numpy as np

    from bagel_tpu_torch.configs import Qwen2Config, SiglipConfig, micro_bagel
    from bagel_tpu_torch.data.packing import make_synthetic_batch, stack_batches
    from bagel_tpu_torch.models.bagel import init_bagel_params
    from bagel_tpu_torch.train.step import (
        init_train_state,
        make_lr_schedule,
        make_optimizer,
        make_train_step,
        tree_leaves,
    )

    # the micro model at the kernel's head dims (LLM 128, SigLIP 72)
    cfg = micro_bagel(
        llm=Qwen2Config(vocab_size=128, hidden_size=256, intermediate_size=256,
                        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
                        rope_theta=10000.0, max_position_embeddings=256),
        vit=SiglipConfig(hidden_size=144, intermediate_size=128, num_hidden_layers=1,
                         num_attention_heads=2, image_size=56, patch_size=14))
    batch = stack_batches([make_synthetic_batch(cfg, np.random.default_rng(0), seq_len=256,
                                                n_text=32, vit_hw=(28, 28),
                                                vae_hw=(32, 32))]).to("cuda")
    noise = torch.randn(batch.vae_patches.shape, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(2))
    finals = []
    for offload in (None, "cpu"):
        params = init_bagel_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                                   torch.float32, device="cuda")
        with torch.no_grad():
            params["llm2vae"]["w"].normal_(0, 0.02,
                                           generator=torch.Generator(device="cuda").manual_seed(3))
        tx = make_optimizer(make_lr_schedule(1e-3, warmup_steps=1), frozen=("vae",))
        state = init_train_state(params, tx, opt_device=offload, ema_device=offload)
        if offload:
            assert all(t.is_pinned() for t in tree_leaves(state.opt_state["mu"]) if t is not None)
        step = make_train_step(cfg, tx, ema_decay=0.9, frozen=("vae",), sparse_block=128)
        losses = []
        before = sparse_flash.sparse_packed_attention.launches
        before_bwd = sparse_flash.sparse_packed_attention_bwd.launches
        for _ in range(3):
            state, m = step(state, batch, noise=noise)
            losses.append(float(m["loss"]))
        per_step = 2 * cfg.llm.num_hidden_layers + cfg.vit.num_hidden_layers
        assert sparse_flash.sparse_packed_attention.launches - before == 3 * per_step
        bwd_per_step = cfg.llm.num_hidden_layers + cfg.vit.num_hidden_layers
        assert sparse_flash.sparse_packed_attention_bwd.launches - before_bwd == 3 * bwd_per_step
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
        finals.append([t.detach().cpu() for t in tree_leaves(state.params)]
                      + [t.cpu() for t in tree_leaves(state.ema_params)])
    assert all(torch.equal(a, b) for a, b in zip(*finals))
