"""Prompt-lookup speculative decode: bagel_tpu_torch vs bagel_tpu (CPU,
fp32).

Bars: `ngram_propose` equal to JAX's on random histories (short ones and
ones whose continuation runs past the buffer included); `decode_text_spec`
giving JAX's tokens and the port's own plain greedy tokens over a grid of
draft_len and ngram, with and without an `active` mask, and the cache
holding exactly the consumed tokens; `gen_text(speculative=K)` equal to the
plain greedy text.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_bagel, tiny_qwen2
from bagel_tpu.data.tokenizer import MockTokenizer as JMockTokenizer
from bagel_tpu.inference import speculative as jspec
from bagel_tpu.inference.engine import BagelEngine as JEngine
from bagel_tpu.models import bagel as jbagel
from bagel_tpu.models import qwen2 as jq
from bagel_tpu_torch.data.tokenizer import MockTokenizer
from bagel_tpu_torch.inference import speculative as tspec
from bagel_tpu_torch.inference.engine import BagelEngine
from bagel_tpu_torch.models import qwen2 as tq
from bagel_tpu_torch.utils.bridge import params_from_numpy

from test_torch_qwen2 import randomized
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

EOS = 2


@pytest.mark.parametrize("n,k", [(1, 3), (2, 4), (3, 7)])
def test_ngram_propose_matches_jax(n, k):
    rng = np.random.default_rng(n * 10 + k)
    ctx = rng.integers(0, 5, (6, 24))  # a small vocabulary: many matches
    lens = np.array([1, 2, n + 1, 10, 23, 24])
    want = jspec.ngram_propose(jnp.asarray(ctx, jnp.int32), jnp.asarray(lens), n, k)
    got = tspec.ngram_propose(torch.tensor(ctx), torch.tensor(lens), n, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ngram_propose_latest_continuation():
    ctx = torch.tensor([[7, 8, 9, 1, 2, 7, 8, 5, 6, 0, 7, 8]])
    assert tspec.ngram_propose(ctx, torch.tensor([12]), n=2, k=3).tolist() == [[5, 6, 0]]


@pytest.fixture(scope="module")
def model():
    cfg = tiny_qwen2(layer_module="mot")
    tree = randomized(jq.init_qwen2_params(jax.random.PRNGKey(0), cfg, jnp.float32), 7)
    tree["lm_head"]["w"] = tree["lm_head"]["w"] * 8.0
    return cfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _prompts(cfg):
    rng = np.random.default_rng(3)
    rep = np.tile([11, 23, 42, 7], 6)  # repetitive: lookups hit
    rnd = rng.integers(3, cfg.vocab_size, 24)  # random: drafts mostly rejected
    return np.stack([rep, rnd, rep[::-1].copy()])


@pytest.mark.parametrize("active", [None, [True, False, True]])
@pytest.mark.parametrize("draft_len,ngram", [(1, 1), (4, 2), (7, 3)])
def test_decode_text_spec_matches_jax_and_plain(model, draft_len, ngram, active):
    cfg, jp, tp = model
    ids = _prompts(cfg)
    b, t = ids.shape
    steps = 16
    pos = np.broadcast_to(np.arange(t)[None], (b, t))
    start = [1, 1, 1]

    with jax.default_matmul_precision("float32"):
        jcache = jq.kv_cache_init(cfg, b, 96, jnp.float32)
        _, jcache = jq.llm_extend(jp, cfg, jq.embed_tokens(jp, jnp.asarray(ids)),
                                  jnp.asarray(pos), jcache, jnp.full((b,), t), und_len=t,
                                  causal=True, update_cache=True, precision="float32")
        want, jout = jspec.decode_text_spec(
            jp, cfg, jcache, jnp.asarray(start), jnp.full((b,), t), jnp.asarray(ids),
            jnp.full((b,), t), max_steps=steps, eos_id=EOS, draft_len=draft_len, ngram=ngram,
            precision="float32", active=None if active is None else jnp.asarray(active))

    tcache = tq.kv_cache_init(cfg, b, 96, torch.float32, device="cpu")
    _, tcache = tq.llm_extend(tp, cfg, tq.embed_tokens(tp, torch.tensor(ids)), torch.tensor(pos),
                              tcache, torch.full((b,), t), und_len=t, causal=True,
                              update_cache=True)
    act = None if active is None else torch.tensor(active)
    stats = {}
    got, tout = tspec.decode_text_spec(
        tp, cfg, tcache, torch.tensor(start), torch.full((b,), t, dtype=torch.int32),
        torch.tensor(ids), torch.full((b,), t), max_steps=steps, eos_id=EOS,
        draft_len=draft_len, ngram=ngram, active=act, stats=stats)
    plain, _ = tq.decode_text(tp, cfg, tcache, torch.tensor(start),
                              torch.full((b,), t, dtype=torch.int32), max_steps=steps,
                              eos_id=EOS, active=act)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(tout.length.numpy(), np.asarray(jout.length))
    assert torch.equal(tcache.length, torch.full((b,), t, dtype=torch.int32))  # not in place
    # the cache holds exactly the consumed inputs
    for r, row in enumerate(got.tolist()):
        if active is not None and not active[r]:
            assert int(tout.length[r]) == t and set(row) == {EOS}
        elif EOS in row:
            assert int(tout.length[r]) == t + row.index(EOS) + 1
        else:
            assert int(tout.length[r]) == t + steps
    assert 1 <= stats["forwards"] <= steps


@pytest.fixture(scope="module")
def engines():
    cfg = tiny_bagel()
    tree = randomized(jbagel.init_bagel_params(jax.random.PRNGKey(0), cfg, jnp.float32), 8)
    jtok, ttok = JMockTokenizer(cfg.llm.vocab_size), MockTokenizer(cfg.llm.vocab_size)
    jeng = JEngine(jax.tree.map(jnp.asarray, tree), cfg, jtok, jtok.new_token_ids, max_kv=512)
    teng = BagelEngine(params_from_numpy(tree, "cpu"), cfg, ttok, ttok.new_token_ids,
                       max_kv=512, device="cpu")
    return jeng, teng


@pytest.mark.parametrize("k,ngram", [(4, 2), (3, 3)])
def test_gen_text_speculative_matches_plain_and_jax(engines, k, ngram):
    jeng, teng = engines
    text = "the quick brown fox jumps over the lazy dog; the quick brown fox jumps again"
    ctx = teng.update_context_text(text, teng.init_context())
    plain = teng.gen_text(ctx, max_length=12)
    spec = teng.gen_text(ctx, max_length=12, speculative=k, ngram=ngram)
    assert spec == plain and len(plain.split()) > 0
    with jax.default_matmul_precision("float32"):
        jctx = jeng.update_context_text(text, jeng.init_context())
        assert jeng.gen_text(jctx, max_length=12, speculative=k, ngram=ngram) == spec


def test_speculative_through_call(engines):
    _, teng = engines
    kw = dict(understanding_output=True, max_think_token_n=8)
    assert teng(text="abc abc abc", speculative=3, **kw) == teng(text="abc abc abc", **kw)


def test_gen_text_speculative_needs_room(engines):
    _, teng = engines
    ctx = teng.update_context_text("hello", teng.init_context())
    with pytest.raises(ValueError, match="KV room"):
        teng.gen_text(ctx, max_length=teng.max_kv - ctx.kv_len, speculative=4)
