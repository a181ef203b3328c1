"""The frozen copies of the yardstick equal the port's originals and
hand-worked values."""

import sys

import torch

from benchmark.harness import tokens, work
from benchmark.tests.micro import ROOT, model


def test_attention_work_and_bound_equal_the_smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    for args in (([0], [37], 64, 4, 2, 16, True), ([5, 0, 9], [3, 3, 3], 3, 28, 4, 128, False),
                 ([4100], [1], 1, 28, 4, 128, True)):
        assert work.attention_work(*args) == chip_smoke.attention_work(*args)
    assert work.bound_ms_at(1e12, 1e9) == chip_smoke.bound_ms_at(1e12, 1e9, chip_smoke.PEAK_FLOPS)
    assert work.PEAK_BF16 == chip_smoke.PEAK_FLOPS and work.PEAK_BYTES == chip_smoke.PEAK_BYTES


def test_attention_work_by_hand():
    # one row, 2 queries over 3 past keys, causal: 2*3 + 3 pairs, 4*d*h flops a pair
    f, b = work.attention_work([3], [2], 2, 1, 1, 4, True)
    assert f == 4 * 4 * 1 * 9
    assert b == 2 * (2 * 1 * 2 * 1 * 4 + 2 * (3 + 2) * 1 * 4)


def test_forward_flops_agree_with_the_port_count():
    """A forward's dense FLOPs are a third of the port's analytic
    forward-and-backward count per token (without the embedding and head)."""
    from bagel_tpu_torch.configs import Qwen2Config
    from bagel_tpu_torch.utils.metrics import qwen2_flop_coefficients

    llm = model()["llm"]
    dense, attn = qwen2_flop_coefficients(Qwen2Config(**llm), mot=False)
    head = 6 * 2 * llm["vocab_size"] * llm["hidden_size"]
    assert 3 * work.forward_flops(llm, 1, 0) == dense - head
    # attention: 12 head_dim heads layers a squared length (fwd + bwd), a
    # forward's 4 head_dim heads layers a visible pair
    assert 3 * work.forward_flops(llm, 0, 1) == attn
    d, f = 64, 128
    assert work.layer_params(llm) == d * (64 + 2 * 32) + 64 * d + 3 * d * f


def test_vae_decode_flops_by_hand():
    vae = {"ch": 2, "ch_mult": [1], "num_res_blocks": 0, "z_channels": 1, "out_ch": 3}
    # conv_in 1->2; mid: two res blocks 2->2 (two 3x3 convs each) and the
    # attention (four 1x1 convs, two h*w x h*w products); the one level's
    # res block (num_res_blocks + 1 = 1); conv_out 2->3; all on 1 x 1
    conv = lambda ci, co, k: 2 * ci * co * k * k  # noqa: E731
    want = conv(1, 2, 3) + 3 * 2 * conv(2, 2, 3) + 4 * conv(2, 2, 1) + 4 * 2 + conv(2, 3, 3)
    assert work.vae_decode_flops(vae, 1, 1) == want


def test_t2i_schedule_counts_equal_the_port():
    import numpy as np
    from bagel_tpu_torch.models.bagel import shifted_timesteps

    p = {"num_timesteps": 50, "timestep_shift": 3.0, "cfg_interval": [0.4, 1.0]}
    ts, _ = shifted_timesteps(50, 3.0)
    on = int(((ts > 0.4) & (ts <= 1.0)).sum())
    assert work.t2i_steps(p) == (on, 49 - on)
    from benchmark.reference.bagel import shifted_timesteps as ref_ts
    a, b = ref_ts(50, 3.0)
    assert np.array_equal(a, ts) and np.array_equal(b, shifted_timesteps(50, 3.0)[1])


def test_mock_tokens_equal_the_port():
    from bagel_tpu_torch.data.tokenizer import MockTokenizer

    tok = MockTokenizer(152064)
    assert tokens.special(152064) == tok.new_token_ids
    assert tokens.encode("Hello, world", 152064) == tok.encode("Hello, world")


def test_weights_are_the_port_tree():
    """The benchmark's weights have the port's tree: the same paths, shapes
    and types as `init_bagel_params` (whose values the benchmark does not use)."""
    from benchmark.harness.program import bagel_config
    from benchmark.harness.weights import make_params
    from bagel_tpu_torch.models.bagel import init_bagel_params

    m = model()
    ours = make_params(m, 3, "cpu", torch.bfloat16)
    theirs = init_bagel_params(torch.Generator().manual_seed(0), bagel_config(m),
                               torch.bfloat16, device="cpu")

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, path

    walk(ours, theirs)
    again = make_params(m, 3, "cpu", torch.bfloat16)
    assert torch.equal(ours["llm"]["layers"]["mlp_gen"]["down"], again["llm"]["layers"]["mlp_gen"]["down"])
    assert not torch.equal(ours["llm"]["layers"]["mlp"]["down"], ours["llm"]["layers"]["mlp_gen"]["down"])
    assert float(ours["llm2vae"]["w"].float().abs().max()) > 0
