"""The fused layer path of `models.qwen2` on the CPU: `llm_extend` with
attn_impl "flash" on bf16 tensors runs `_layer_extend_fused` over the plain
versions of `ops.layer_elementwise`'s kernels, and must give the plain
path's bits (the split by row changes which rows each product reads, not
the arithmetic); and the `Split` bookkeeping those versions rest on.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_dist_util import run

from bagel_tpu_torch.configs import tiny_bagel, tiny_qwen2
from bagel_tpu_torch.models import qwen2
from bagel_tpu_torch.ops import layer_elementwise as le
from bagel_tpu_torch.ops.norms import rms_norm
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)


def _params(cfg, seed=0):
    """bf16 weights whose experts differ and whose norms are not 1."""
    gen = torch.Generator().manual_seed(seed)
    params = qwen2.init_qwen2_params(gen, cfg, torch.bfloat16, device="cpu")

    def perturb(tree):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                perturb(leaf)
            else:
                tree[key] = leaf + 0.05 * torch.randn(leaf.shape, generator=gen).to(leaf.dtype)

    perturb(params)
    return params, gen


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("update_cache", [True, False])
@pytest.mark.parametrize("und_len", [0, 2, 6])
@pytest.mark.parametrize("layer_module,qk_norm", [("mot", True), ("mot", False),
                                                  ("dense", True)])
def test_fused_path_gives_the_plain_bits(layer_module, qk_norm, und_len, update_cache,
                                         kv_dtype, monkeypatch):
    cfg = tiny_qwen2(layer_module=layer_module, qk_norm=qk_norm)
    params, gen = _params(cfg)
    if und_len == 2:
        params = qwen2.fuse_llm_params(params)  # fused and separate leaves both
    b, t = 2, 6
    cache = qwen2.kv_cache_init(cfg, b, 32, kv_dtype, device="cpu")
    cache.length.copy_(torch.tensor([3, 29], dtype=torch.int32))  # row 1's start clamps
    x = torch.randn((b, t, cfg.hidden_size), generator=gen).bfloat16()
    pos = torch.arange(t)[None].expand(b, t).int() + 7
    valid = torch.tensor([t, t - 1], dtype=torch.int32)
    kw = dict(und_len=und_len, causal=True, update_cache=update_cache, kv_bound=29)
    want, wc = qwen2.llm_extend(params, cfg, x, pos, cache, valid, attn_impl="plain", **kw)
    monkeypatch.setattr(qwen2, "_layer_extend", lambda *a, **k: pytest.fail("plain layer ran"))
    got, gc = qwen2.llm_extend(params, cfg, x, pos, cache, valid, attn_impl="flash", **kw)
    assert torch.equal(got, want)
    for g, w in zip(gc.buffers(), wc.buffers()):
        assert (g is None and w is None) or torch.equal(g, w)
    assert torch.equal(gc.length, wc.length)


def test_fused_path_decode_step_gives_the_plain_bits():
    """T = 1 blocks of the decode loop (und expert only), eager."""
    cfg = tiny_qwen2(layer_module="mot", qk_norm=True)
    params, gen = _params(cfg, 1)
    cache = qwen2.kv_cache_init(cfg, 3, 64, device="cpu", dtype=torch.bfloat16)
    cache.length.copy_(torch.tensor([4, 9, 0], dtype=torch.int32))
    start = torch.tensor([5, 6, 7])
    outs = [qwen2.decode_text(params, cfg, cache, start, cache.length.clone(), max_steps=5,
                              eos_id=-1, attn_impl=impl) for impl in ("plain", "flash")]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1].k, outs[1][1].k)


def test_fused_path_under_tp_gives_the_plain_bits(tmp_path):
    """Megatron tp = 2 (gloo): the fused layers merge o's and down's partial
    sums into one block for one all-reduce each, as the plain layers do."""
    cfg = tiny_bagel()
    ranks = run("fused_tp", 2, tmp_path, deadline=120.0, cfg=cfg, seed=5)
    for r in ranks:
        plain, fused = r["plain"], r["flash"]
        assert np.array_equal(fused["hidden"], plain["hidden"])
        assert np.array_equal(fused["k"], plain["k"])
        assert fused["collectives"] == plain["collectives"]
        assert plain["collectives"][("all_reduce", "eager")] >= 2 * cfg.llm.num_hidden_layers


def test_fused_path_is_taken_only_with_kernels_and_bf16():
    x16 = torch.zeros((1, 2, 8), dtype=torch.bfloat16)
    assert qwen2._fused("flash", x16)
    assert not qwen2._fused("auto", x16)  # CPU tensors: the plain path
    assert not qwen2._fused("plain", x16)
    assert not qwen2._fused("flash", x16.float())


def _split_cases():
    gen = torch.Generator().manual_seed(3)
    b, t, w = 2, 7, 8
    x = torch.randn((b, t, w), generator=gen).bfloat16()
    for u in (0, 3, 7):
        own = le.Split(x[:, :u].clone() if u else None, x[:, u:].clone() if u < t else None,
                       u, t)
        whole_gen = dataclasses.replace(own, gen=None if u == t else x.clone())
        yield u, x, own
        yield u, x, whole_gen
        yield u, x, le.Split.block(x, u)


def test_split_reads_each_expert_rows():
    for u, x, s in _split_cases():
        assert torch.equal(s.whole(), x)
        for e, _ in s.parts():
            assert torch.equal(s.rows(e), x[:, :u] if e == 0 else x[:, u:])
            assert s.start(e) == (u if e == 1 and s.gen.shape[1] != s.t else 0)
        assert torch.equal(s.merged(), x)


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_are_the_layer_chain(w_dtype):
    """Each plain version is the plain layer's chain on the experts' rows:
    res + o, then `rms_norm` with each expert's weight; `F.silu(gate) * up`."""
    gen = torch.Generator().manual_seed(4)
    w = tuple((1 + 0.2 * torch.randn(8, generator=gen)).to(w_dtype) for _ in range(2))
    res = torch.randn((2, 7, 8), generator=gen).bfloat16()
    for u, x, o in _split_cases():
        y, n = le.add_rms_norm(o, w, 1e-6, res=res)
        assert torch.equal(y, res + x)
        want = qwen2._split_apply(res + x, u, lambda z: rms_norm(z, w[0], 1e-6),
                                  lambda z: rms_norm(z, w[1], 1e-6))
        assert torch.equal(n.whole(), want)
        assert le.add_rms_norm(o, w, 1e-6, res=res, final=True)[0] is None
        assert torch.equal(le.add_rms_norm(o, w, 1e-6, res=res, final=True)[1], want)
        act = le.silu_mul(o, o.map(torch.neg, torch.neg))
        assert torch.equal(act.whole(), torch.nn.functional.silu(x) * -x)


def test_kernel_descriptors_locate_each_expert_rows():
    """The kernels' (pointer, batch stride, row stride, t0) per expert: a
    gen part holding the whole block starts at token 0, its own rows at
    und_len; a part that splits no block of T tokens is refused."""
    x = torch.zeros((2, 7, 16), dtype=torch.bfloat16)
    d = list(le._desc(le.Split(x[:, :3].clone(), x.clone(), 3, 7), "x"))
    assert (d[1], d[2], d[3], d[5], d[6], d[7]) == (48, 16, 0, 112, 16, 0)
    assert list(le._desc(le.Split(x[:, :3].clone(), x[:, 3:].clone(), 3, 7), "x"))[7] == 3
    with pytest.raises(ValueError, match="do not split"):
        le._desc(le.Split(x[:, :3].clone(), x[:, :5].clone(), 3, 7), "x")
    with pytest.raises(TypeError):
        le._desc(le.Split.block(x.float(), 3), "x")
