"""bagel_tpu_torch decode_text vs bagel_tpu decode_text (CPU, fp32).

Both decode from the same prefilled cache of a randomized tiny MoT. Bars:
greedy tokens identical, the first step's logits within 1e-4; eos padding
after stop with early_stop on and off; frozen rows under `active`; sampling
reproducible from a seeded generator; the given cache left untouched.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bagel_tpu.configs import tiny_qwen2
from bagel_tpu.models import qwen2 as jq
from bagel_tpu_torch.models import qwen2 as tq
from bagel_tpu_torch.utils.bridge import params_from_numpy

from test_torch_qwen2 import randomized

STEPS = 12


@pytest.fixture(scope="module")
def prefilled():
    """A causal prefill of two ragged rows into both packages' caches."""
    cfg = tiny_qwen2()
    tree = randomized(jq.init_qwen2_params(jax.random.PRNGKey(0), cfg, jnp.float32), 11)
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    b, t, s = 2, 16, 64
    valid = np.asarray([13, 9], np.int32)
    pos = np.zeros((b, t), np.int32)
    for r in range(b):
        pos[r, : valid[r]] = np.arange(valid[r])
    x = np.random.default_rng(12).standard_normal((b, t, cfg.hidden_size)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        _, jcache = jq.llm_extend(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                                  jq.kv_cache_init(cfg, b, s, jnp.float32), jnp.asarray(valid),
                                  und_len=t, causal=True, update_cache=True)
    _, tcache = tq.llm_extend(tp, cfg, torch.tensor(x), torch.tensor(pos),
                              tq.kv_cache_init(cfg, b, s, torch.float32, device="cpu"),
                              torch.tensor(valid), und_len=t, causal=True, update_cache=True)
    start = np.asarray([5, 7], np.int32)
    return cfg, jp, tp, jcache, tcache, start, valid


def _decode(prefilled, eos_id, **kw):
    cfg, jp, tp, jcache, tcache, start, valid = prefilled
    active = kw.pop("active", None)
    with jax.default_matmul_precision("float32"):
        jtoks, jc = jq.decode_text(
            jp, cfg, jcache, jnp.asarray(start), jnp.asarray(valid), max_steps=STEPS,
            eos_id=eos_id, active=None if active is None else jnp.asarray(active), **kw)
    ttoks, tc = tq.decode_text(
        tp, cfg, tcache, torch.tensor(start), torch.tensor(valid), max_steps=STEPS,
        eos_id=eos_id, active=None if active is None else torch.tensor(active), **kw)
    return np.asarray(jtoks), ttoks.numpy(), jc, tc


def test_greedy_tokens_and_first_logits_match_jax(prefilled):
    cfg, jp, tp, jcache, tcache, start, valid = prefilled
    k0, v0 = tcache.k.clone(), tcache.v.clone()
    want, got, jc, tc = _decode(prefilled, eos_id=cfg.vocab_size - 1, early_stop=False)
    np.testing.assert_array_equal(got, want)
    assert len(set(got[0].tolist())) > 1  # not one token over and over
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=1e-4, atol=1e-4)
    # the loop wrote into its own clone: the given cache is untouched
    assert torch.equal(tcache.k, k0) and torch.equal(tcache.v, v0)
    # the first step's logits
    emb = np.asarray(jq.embed_tokens(jp, jnp.asarray(start)))[:, None]
    with jax.default_matmul_precision("float32"):
        jh, _ = jq.llm_extend(jp, cfg, jnp.asarray(emb), jnp.asarray(valid)[:, None], jcache,
                              jnp.ones(2, jnp.int32), und_len=1, causal=True,
                              update_cache=False)
        jlog = jq.lm_logits(jp, jh[:, 0], precision="float32")
    th, _ = tq.llm_extend(tp, cfg, torch.tensor(emb), torch.tensor(valid)[:, None], tcache,
                          torch.ones(2, dtype=torch.int32), und_len=1, causal=True,
                          update_cache=False)
    np.testing.assert_allclose(tq.lm_logits(tp, th[:, 0]).numpy(), np.asarray(jlog),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[:, 0], np.asarray(jlog).argmax(-1))


@pytest.mark.parametrize("early_stop", [True, False])
def test_eos_padding_after_stop(prefilled, early_stop):
    """eos is the token row 0 emits at step 3: row 0 stops there and is
    eos-padded after it, on both sides."""
    cfg = prefilled[0]
    free, _, _, _ = _decode(prefilled, eos_id=cfg.vocab_size - 1, early_stop=False)
    eos = int(free[0, 3])
    want, got, jc, tc = _decode(prefilled, eos_id=eos, early_stop=early_stop)
    np.testing.assert_array_equal(got, want)
    first = int(np.argmax(got[0] == eos))
    assert first <= 3 and (got[0, first:] == eos).all()
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_active_rows_are_frozen(prefilled):
    cfg, _, _, _, tcache, _, valid = prefilled
    want, got, jc, tc = _decode(prefilled, eos_id=cfg.vocab_size - 1, early_stop=False,
                                active=np.asarray([True, False]))
    np.testing.assert_array_equal(got, want)
    assert (got[1] == cfg.vocab_size - 1).all()
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    assert tc.length.tolist() == [valid[0] + STEPS, valid[1]]
    np.testing.assert_allclose(tc.k[:, 0].numpy(), np.asarray(jc.k)[:, 0], rtol=1e-4, atol=1e-4)


def test_sampling_is_reproducible(prefilled):
    cfg, _, tp, _, tcache, start, valid = prefilled

    def sample(seed):
        toks, _ = tq.decode_text(tp, cfg, tcache, torch.tensor(start), torch.tensor(valid),
                                 max_steps=STEPS, eos_id=cfg.vocab_size - 1, do_sample=True,
                                 temperature=1.5, generator=torch.Generator().manual_seed(seed))
        return toks

    a, b, c = sample(3), sample(3), sample(4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    greedy, _ = tq.decode_text(tp, cfg, tcache, torch.tensor(start), torch.tensor(valid),
                               max_steps=STEPS, eos_id=cfg.vocab_size - 1)
    assert not torch.equal(a, greedy)
