"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from bagel_tpu_torch.ops import flash
from bagel_tpu_torch.ops import sparse_flash


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
@pytest.mark.parametrize("h,kh,d,train", [(16, 16, 72, False), (28, 4, 128, True)])
def test_sparse_kernel_matches_plain_on_card(h, kh, d, train):
    """B3 at SigLIP's head dim (three packed images and a padded tail) and
    at the LLM's training shape (GQA 28/4 under the full causal + fan +
    noise predicate); S is ragged (not a multiple of the 64-row tile)."""
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
