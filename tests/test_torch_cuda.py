"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from bagel_tpu_torch.ops import flash


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
