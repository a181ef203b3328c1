"""The decode program's chunked steps (bagel_tpu_torch.inference.decode_program)
against bagel_tpu's compiled decode loops (CPU, fp32 weights; int8 caches
make the attention bf16 on both sides).

On CPU tensors a `DecodeProgram` runs the same step function its CUDA graphs
capture, eagerly, chunk by chunk, with one read of the host a chunk. Bars:
- greedy tokens and final cache lengths identical to JAX's `decode_text`,
  with early_stop on and off, with and without a frozen-row mask, with
  chunks that do not divide max_steps and rows that stop mid-chunk, over
  fp32 and int8 caches; the cache contents within 1e-4 of JAX's wherever
  JAX wrote (a step past the exit writes nothing);
- `decode_text_spec` identical to JAX's for K in {2, 4}, the same way;
- a row at a full buffer: the chunk's tail writes nothing out of range and
  the buffer equals JAX's (whose writes clamp the same way);
- a chunk reads nothing back to the host (Tensor.item, tolist, __bool__,
  __int__ and __float__ raise while it runs);
- the serving runtime and `chat_batch` through the program answer as
  bagel_tpu does;
- a program keeps at most two caches of its own, holds its lock while it
  decodes, and drops the graphs over a cache the runtime replaces; the int8
  verify's prefix takes one of four bounds; replayed kernel nodes map to
  the wrappers' launches.
"""

import collections
import contextlib

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
from bagel_tpu_torch.inference.decode_program import DecodeProgram
from bagel_tpu_torch.inference.engine import BagelEngine
from bagel_tpu_torch.models import qwen2 as tq
from bagel_tpu_torch.serving.runtime import ServingRuntime
from bagel_tpu_torch.utils.bridge import params_from_numpy

from asserts import assert_close_live
from test_torch_qwen2 import randomized

TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 11
VALID = [9, 5, 7]  # the prefill's ragged rows
DTYPES = {"fp32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module")
def model():
    cfg = tiny_qwen2(layer_module="mot")
    # seed 53: a token that every row emits within STEPS, at steps 3, 1 and 5
    tree = randomized(jq.init_qwen2_params(jax.random.PRNGKey(0), cfg, jnp.float32), 53)
    tree["lm_head"]["w"] = tree["lm_head"]["w"] * 8.0  # sharp logits: no near ties
    return cfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _prefilled(model, kv, s=48):
    """A causal prefill of three ragged rows into both packages' caches."""
    cfg, jp, tp = model
    b, t = len(VALID), max(VALID)
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (b, t))
    pos = np.broadcast_to(np.arange(t)[None], (b, t))
    jdt, tdt = DTYPES[kv]
    with jax.default_matmul_precision("float32"):
        _, jcache = jq.llm_extend(jp, cfg, jq.embed_tokens(jp, jnp.asarray(ids)), jnp.asarray(pos),
                                  jq.kv_cache_init(cfg, b, s, jdt), jnp.asarray(VALID),
                                  und_len=t, causal=True, update_cache=True, precision="float32")
    _, tcache = tq.llm_extend(tp, cfg, tq.embed_tokens(tp, torch.tensor(ids)), torch.tensor(pos),
                              tq.kv_cache_init(cfg, b, s, tdt, device="cpu"), torch.tensor(VALID),
                              und_len=t, causal=True, update_cache=True)
    return ids, jcache, tcache


def _jax_decode(model, jcache, eos, **kw):
    cfg, jp, _ = model
    active = kw.pop("active", None)
    with jax.default_matmul_precision("float32"):
        return jq.decode_text(jp, cfg, jcache, jnp.asarray([1, 2, 3]), jnp.asarray(VALID),
                              max_steps=STEPS, eos_id=eos, precision="float32",
                              active=None if active is None else jnp.asarray(active), **kw)


def _eos(model, jcache, which):
    """eos ids: none ever emitted, the token row 0 emits at step 3, or one
    that every row emits (rows stop at different steps, mid-chunk)."""
    if which == "none":
        return -1
    free = np.asarray(_jax_decode(model, jcache, -1, early_stop=False)[0])
    if which == "row0":
        return int(free[0, 3])
    common = set(free[0]) & set(free[1]) & set(free[2])
    assert common, "the model no longer has a token that every row emits"
    return int(min(common, key=lambda tok: max(list(r).index(tok) for r in free)))


def _same_buffers(tout, jout):
    """The whole cache as JAX left it: fp32 K/V within 1e-4; int8 scales
    within 1e-4 and at most 1% of the codes one step off (a K/V within float
    noise of a rounding boundary), none further."""
    if tout.k.dtype == torch.int8:
        for mine, theirs in ((tout.k_scale, jout.k_scale), (tout.v_scale, jout.v_scale)):
            assert_close_live(mine.numpy(), np.asarray(theirs), name="KV scales", floor=1e-6,
                              **TOL)
        for mine, theirs in ((tout.k, jout.k), (tout.v, jout.v)):
            diff = np.abs(mine.numpy().astype(np.int32) - np.asarray(theirs).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (diff.max(), (diff > 0).mean())
    else:
        for mine, theirs in ((tout.k, jout.k), (tout.v, jout.v)):
            assert_close_live(mine.numpy(), np.asarray(theirs), name="KV cache", **TOL)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("chunk", [1, 4, 16])
@pytest.mark.parametrize("early_stop,active,eos", [
    (True, None, "all"), (True, None, "row0"), (False, None, "row0"),
    (True, [True, False, True], "all"), (False, [True, False, True], "none"),
])
def test_chunked_decode_matches_jax(model, kv, chunk, early_stop, active, eos):
    cfg, _, tp = model
    _, jcache, tcache = _prefilled(model, kv)
    eos_id = _eos(model, jcache, eos)
    want, jout = _jax_decode(model, jcache, eos_id, early_stop=early_stop, active=active)
    prog = DecodeProgram(chunk=chunk)
    stats = {}
    got, tout = tq.decode_text(
        tp, cfg, tcache, torch.tensor([1, 2, 3]), torch.tensor(VALID, dtype=torch.int32),
        max_steps=STEPS, eos_id=eos_id, early_stop=early_stop,
        active=None if active is None else torch.tensor(active), program=prog, stats=stats)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tout.length.numpy(), np.asarray(jout.length))
    n = min(chunk, STEPS)
    assert stats["forwards"] % n == 0 and stats["forwards"] >= int(
        (np.asarray(jout.length) - np.asarray(VALID)).max())
    if eos == "all" and early_stop and n < STEPS:  # JAX left early: so did the chunks
        assert stats["forwards"] < -(-STEPS // n) * n
    _same_buffers(tout, jout)  # a step past the exit wrote nothing
    # the given cache is untouched: the program decoded in its own copy
    assert tout.k is not tcache.k
    np.testing.assert_array_equal(tcache.length.numpy(), VALID)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("spec_chunk", [1, 3])
@pytest.mark.parametrize("k,active", [(2, None), (4, None), (4, [True, False, True])])
def test_chunked_speculative_matches_jax(model, kv, spec_chunk, k, active):
    cfg, jp, tp = model
    ids, jcache, tcache = _prefilled(model, kv)
    eos_id = _eos(model, jcache, "row0")
    hist = np.concatenate([ids, ids[:, ::-1]], axis=1)  # lookups hit in the second half
    hist_len = np.asarray(VALID) + ids.shape[1]
    act = None if active is None else np.asarray(active)
    with jax.default_matmul_precision("float32"):
        want, jout = jspec.decode_text_spec(
            jp, cfg, jcache, jnp.asarray([1, 2, 3]), jnp.asarray(VALID), jnp.asarray(hist),
            jnp.asarray(hist_len), max_steps=STEPS, eos_id=eos_id, draft_len=k, ngram=2,
            precision="float32", active=None if act is None else jnp.asarray(act))
    stats = {}
    got, tout = tspec.decode_text_spec(
        tp, cfg, tcache, torch.tensor([1, 2, 3]), torch.tensor(VALID, dtype=torch.int32),
        torch.tensor(hist), torch.tensor(hist_len), max_steps=STEPS, eos_id=eos_id,
        draft_len=k, ngram=2, active=None if act is None else torch.tensor(act),
        program=DecodeProgram(spec_chunk=spec_chunk), stats=stats)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tout.length.numpy(), np.asarray(jout.length))
    assert stats["forwards"] % min(spec_chunk, STEPS) == 0 and stats["forwards"] <= STEPS + 2


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_full_buffer_writes_stay_in_range(model, kv):
    """Row 0 fills its buffer exactly at the last step; row 1 is frozen at a
    full buffer. The chunks (4 steps; 11 do not divide) write nothing out of
    range, and every entry equals JAX's (JAX's writes clamp into the buffer
    too: a frozen row at a full buffer rewrites its last entry)."""
    cfg, jp, tp = model
    s, b = 32, 2
    jdt, tdt = DTYPES[kv]
    valid = [s - STEPS, s]
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (b, s))
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    active = np.asarray([True, False])
    with jax.default_matmul_precision("float32"):
        _, jcache = jq.llm_extend(jp, cfg, jq.embed_tokens(jp, jnp.asarray(ids)), jnp.asarray(pos),
                                  jq.kv_cache_init(cfg, b, s, jdt), jnp.asarray(valid), und_len=s,
                                  causal=True, update_cache=True, precision="float32")
        want, jout = jq.decode_text(jp, cfg, jcache, jnp.asarray([1, 2]), jnp.asarray(valid),
                                    max_steps=STEPS, eos_id=-1, precision="float32",
                                    active=jnp.asarray(active))
    _, tcache = tq.llm_extend(tp, cfg, tq.embed_tokens(tp, torch.tensor(ids)), torch.tensor(pos),
                              tq.kv_cache_init(cfg, b, s, tdt, device="cpu"), torch.tensor(valid),
                              und_len=s, causal=True, update_cache=True)
    got, tout = tq.decode_text(tp, cfg, tcache, torch.tensor([1, 2]),
                               torch.tensor(valid, dtype=torch.int32), max_steps=STEPS, eos_id=-1,
                               active=torch.tensor(active), program=DecodeProgram(chunk=4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tout.length.tolist() == [s, s] == np.asarray(jout.length).tolist()
    _same_buffers(tout, jout)


def test_a_live_row_past_the_buffer_raises(model):
    cfg, _, tp = model
    _, _, tcache = _prefilled(model, "fp32", s=16)  # rows at 9, 5, 7 of 16
    with pytest.raises(ValueError, match="KV buffer too small"):
        tq.decode_text(tp, cfg, tcache, torch.tensor([1, 2, 3]),
                       torch.tensor(VALID, dtype=torch.int32), max_steps=STEPS, eos_id=-1,
                       program=DecodeProgram(chunk=4))


@contextlib.contextmanager
def _no_host_reads():
    def refuse(*_a, **_k):
        raise AssertionError("a host read inside a decode chunk")

    names = ("item", "tolist", "__bool__", "__int__", "__float__")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    try:
        for n in names:
            setattr(torch.Tensor, n, refuse)
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_a_chunk_reads_nothing_back(model, kv, monkeypatch):
    cfg, _, tp = model
    ids, _, tcache = _prefilled(model, kv)
    real = DecodeProgram.run
    runs = []

    def guarded(self, *a, **kw):
        with _no_host_reads():
            real(self, *a, **kw)
        runs.append(1)

    monkeypatch.setattr(DecodeProgram, "run", guarded)
    start, pos = torch.tensor([1, 2, 3]), torch.tensor(VALID, dtype=torch.int32)
    tq.decode_text(tp, cfg, tcache, start, pos, max_steps=STEPS, eos_id=-1,
                   program=DecodeProgram(chunk=4), active=torch.tensor([True, False, True]))
    tq.decode_text(tp, cfg, tcache, start, pos, max_steps=6, eos_id=-1, do_sample=True,
                   generator=torch.Generator().manual_seed(1), program=DecodeProgram(chunk=4))
    tspec.decode_text_spec(tp, cfg, tcache, start, pos, torch.tensor(ids),
                           torch.tensor(VALID), max_steps=STEPS, eos_id=-1, draft_len=3,
                           program=DecodeProgram(spec_chunk=2))
    assert len(runs) == 3 + 2 + 6  # chunks: ceil(11 / 4), ceil(6 / 4), ceil(11 / 2)


def test_sampled_chunks_match_one_chunk(model):
    """Sampling draws from the caller's generator in step order: the tokens do
    not depend on the chunk, and the generator moves on."""
    cfg, _, tp = model
    _, _, tcache = _prefilled(model, "fp32")

    def sample(chunk, gen):
        toks, _ = tq.decode_text(tp, cfg, tcache, torch.tensor([1, 2, 3]),
                                 torch.tensor(VALID, dtype=torch.int32), max_steps=STEPS,
                                 eos_id=-1, do_sample=True, temperature=1.5, generator=gen,
                                 program=DecodeProgram(chunk=chunk))
        return toks

    gen = torch.Generator().manual_seed(3)
    a = sample(STEPS, gen)
    assert torch.equal(a, sample(STEPS, torch.Generator().manual_seed(3)))
    assert torch.equal(a, sample(4, torch.Generator().manual_seed(3)))
    assert not torch.equal(a, sample(STEPS, gen))  # the generator moved on


def test_program_keeps_one_entry_per_key_and_drops_old_buffers(model):
    """A second decode of the same key reuses the entry; new cache buffers
    (the runtime's recovered cache) replace it."""
    cfg, _, tp = model
    prog = DecodeProgram(chunk=4)
    start, pos = torch.tensor([1, 2, 3]), torch.tensor(VALID, dtype=torch.int32)
    caches = [_prefilled(model, "fp32")[2] for _ in range(2)]
    outs = [tq.decode_text(tp, cfg, c, start, pos, max_steps=STEPS, eos_id=-1, program=prog,
                           in_place=True)[0] for c in (caches[0], caches[0], caches[1])]
    assert len(prog._entries) == 1
    (entry,) = prog._entries.values()
    assert entry.buffers[0] == caches[1].k.data_ptr()
    assert torch.equal(outs[0], outs[2])


@pytest.fixture(scope="module")
def engines():
    cfg = tiny_bagel()
    tree = randomized(jbagel.init_bagel_params(jax.random.PRNGKey(0), cfg, jnp.float32), 11)
    tree["llm"]["lm_head"]["w"] = tree["llm"]["lm_head"]["w"] * 8.0
    jtok, ttok = JMockTokenizer(cfg.llm.vocab_size), MockTokenizer(cfg.llm.vocab_size)
    jparams, tparams = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")

    def pair(**kw):
        teng = BagelEngine(tparams, cfg, ttok, ttok.new_token_ids, max_kv=512, device="cpu", **kw)
        teng.decode = DecodeProgram(chunk=5)  # chunks that divide no budget here
        return JEngine(jparams, cfg, jtok, jtok.new_token_ids, max_kv=512, **kw), teng

    return pair


def _image(rng, h, w):
    return (rng.standard_normal((h, w, 3)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("kv_quant,speculative", [(False, 0), (True, 0), (False, 2)])
def test_runtime_through_the_program_matches_jax(engines, kv_quant, speculative):
    """Three requests on two slots, chunks of 5 steps over 9-token budgets:
    the answers JAX's chat_batch gives for each request alone."""
    jeng, teng = engines(kv_quant=kv_quant)
    rng = np.random.default_rng(6)
    requests = [("what is this? what is this?", _image(rng, 28, 28)), ("just text", None),
                ("the cat and the cat and the", None)]
    rt = ServingRuntime(teng, slots=2, decode_chunk=5, max_new_default=9,
                        speculative=speculative, ngram=2)
    rt.start()
    try:
        got = [f.result(timeout=300) for f in [rt.submit_chat(p, image=im) for p, im in requests]]
    finally:
        rt.stop()
    assert rt.decode.replays == 0 and rt.decode.captures == 0  # CPU: no graphs
    with jax.default_matmul_precision("float32"):
        want = [jeng.chat_batch([im], [p], max_length=9)[0] for p, im in requests]
    assert got == want


def test_chat_batch_reuses_the_programs_cache(engines):
    """chat_batch prefills into the program's own cache, whose stale entries
    from an earlier call change nothing."""
    jeng, teng = engines()
    rng = np.random.default_rng(8)
    first = teng.chat_batch([_image(rng, 28, 28), None], ["a long first question", "b"],
                            max_length=7)
    images, prompts = [None, _image(rng, 28, 42)], ["x", "what is in the second image?"]
    again = teng.chat_batch(images, prompts, max_length=7)
    assert len(teng.decode._owned) == 1 and len(first) == 2
    with jax.default_matmul_precision("float32"):
        assert again == jeng.chat_batch(images, prompts, max_length=7)


def test_program_keeps_two_owned_caches(model):
    """Past MAX_OWNED caches of its own, a program drops the least recently
    used one and the graph entries over it."""
    from bagel_tpu_torch.inference.decode_program import MAX_OWNED

    cfg, _, tp = model
    prog = DecodeProgram(chunk=4)
    start, pos = torch.tensor([1, 2, 3]), torch.tensor(VALID, dtype=torch.int32)
    for s in (32, 40, 48):
        tq.decode_text(tp, cfg, _prefilled(model, "fp32", s=s)[2], start, pos, max_steps=3,
                       eos_id=-1, program=prog)
    assert len(prog._owned) == MAX_OWNED == 2
    assert sorted(e.state.cache.max_len for e in prog._entries.values()) == [40, 48]
    assert sorted(c.max_len for c in prog._owned.values()) == [40, 48]


def test_decodes_hold_the_programs_lock(model, monkeypatch):
    """Every chunk of decode_text and decode_text_spec runs under the
    program's lock: one caller at a time on its static buffers."""
    cfg, _, tp = model
    ids, _, tcache = _prefilled(model, "fp32")
    real, held = DecodeProgram.run, []

    def run(self, *a, **kw):
        held.append(self.lock._is_owned())
        real(self, *a, **kw)

    monkeypatch.setattr(DecodeProgram, "run", run)
    prog = DecodeProgram(chunk=4, spec_chunk=2)
    start, pos = torch.tensor([1, 2, 3]), torch.tensor(VALID, dtype=torch.int32)
    tq.decode_text(tp, cfg, tcache, start, pos, max_steps=6, eos_id=-1, program=prog)
    tspec.decode_text_spec(tp, cfg, tcache, start, pos, torch.tensor(ids), torch.tensor(VALID),
                           max_steps=6, eos_id=-1, draft_len=2, program=prog)
    assert len(held) >= 2 + 1 and all(held)
    assert not prog.lock._is_owned()


def test_recovered_runtime_cache_drops_its_graph_entries(engines):
    """The serving runtime's `_recover_cache` releases the old slot cache:
    no program entry keeps it alive."""
    _, teng = engines()
    rt = ServingRuntime(teng, slots=2, decode_chunk=5, max_new_default=4)
    rt.start()
    try:
        rt.submit_chat("just text").result(timeout=300)
    finally:
        rt.stop()
    assert len(rt.decode._entries) == 1
    rt._recover_cache(RuntimeError("a failed chunk"))
    assert len(rt.decode._entries) == 0


def test_int8_verify_prefix_takes_four_bounds():
    """The int8 verify's dequantized prefix covers what the decode needs and
    takes one of four bounds of the buffer, so a serving run whose longest
    row grows captures at most four verify graphs."""
    s = 8192
    bounds = [tspec.prefix_bound(n, s) for n in range(1, s + 1)]
    assert sorted(set(bounds)) == [2048, 4096, 6144, 8192]
    assert all(b >= n for n, b in zip(range(1, s + 1), bounds))
    assert tspec.prefix_bound(s + 5, s) == s


def test_replayed_launches_read_each_wrappers_kernel(monkeypatch):
    """The replayed kernel nodes (nvcc's mangled names) map to the kernel
    wrappers they stand for, one node a launch: B1's split kernel (T = 1)
    and its T > 1 kernel, not the combine; B1-kv8's split kernel; B4."""
    from bagel_tpu_torch.inference import decode_program
    from bagel_tpu_torch.ops import flash, int4_matmul

    ns = "_ZN58_GLOBAL__N__5813a5a7_25_flash_cached_attention_cu_5ee3ddcc"
    names = {
        ns + "25flash_decode_split_kernelI13__nv_bfloat16EEvPKS1_PKT_S6_PKfS8_PfS9_PKiSB_ii": 6,
        ns + "25flash_decode_split_kernelIaEEvPK13__nv_bfloat16PKT_S6_PKfS8_PfS9_PKiSB_ii": 4,
        ns + "27flash_decode_combine_kernelEPKfS1_P13__nv_bfloat16iiNS_7StridesE": 10,
        ns + "29flash_cached_attention_kernelENS_4MapsEP13__nv_bfloat16NS_7StridesEPKiS5_": 2,
        "_ZN47_GLOBAL__N__403f7b36_14_int4_matmul_cu_31530a4418int4_matmul_kernelILi1EEEvPK": 8,
        "ampere_bf16_s16816gemm_bf16_64x64_sliced1x2_ldg8_f2f_tn": 40,
    }
    monkeypatch.setattr(decode_program, "replayed_kernels", collections.Counter(names))
    assert decode_program.replayed_launches(flash.flash_cached_attention) == 6 + 2
    assert decode_program.replayed_launches(flash.flash_decode_kv8) == 4
    assert decode_program.replayed_launches(int4_matmul.int4_matmul) == 8
    assert decode_program.replayed_launches(flash.flash_cached_attention_q8) == 0
