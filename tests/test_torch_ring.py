"""bagel_tpu_torch.ops.ring vs bagel_tpu.ops.ring (tests/test_ring.py:24,
51, 93), fp32 both sides, the port's rings over gloo processes.

- `ring_attention`, causal on and off at sp 2 and 4, and
  `ring_packed_attention` at sp 4 (also with the block in query chunks):
  against JAX's ring under `shard_map` on the CPU mesh and against the
  dense masked attention, within 2e-5.
- Context parallelism in the train step: compute_losses' gradients with
  `context_parallel` over a 4-way fsdp axis (the ring inside every layer,
  the parameters sharded over the same axis) against JAX's dense-mask path,
  within 1e-4 relative per leaf, the loss within 1e-5.
"""

from functools import partial

import numpy as np
import pytest
from asserts import assert_close_live

import jax
from jax.sharding import Mesh, PartitionSpec as P

from bagel_tpu.ops.attention import dot_attention, train_packed_mask
from bagel_tpu.ops.ring import ring_attention, ring_packed_attention
from bagel_tpu.train import step as jstep
from torch_dist_util import run
from torch_train_util import configs, jax_batch, jax_leaves, jax_params, rel_err

TOL = 2e-5
RING = [(False, 2), (True, 2), (False, 4), (True, 4)]
PACKED = [None, 4]  # the port's q_chunk


def _qkv(rng, b, s, h, kh, d):
    return [rng.standard_normal((b, s, n, d)).astype(np.float32) for n in (h, kh, kh)]


def _ids():
    doc = np.asarray([1] * 12 + [2] * 14 + [0] * 6, np.int32)
    fan = np.asarray([-1] * 4 + [0] * 8 + [-1] * 6 + [1] * 8 + [-1] * 6, np.int32)
    noi = np.asarray([-1] * 4 + [0] * 8 + [-1] * 20, np.int32)
    return doc, fan, noi


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    """Every case through the port (one 4-process run) and through JAX."""
    rng = np.random.default_rng(0)
    cases, jax_out, dense = [], [], []
    with jax.default_matmul_precision("float32"):
        for causal, sp in RING:
            q, k, v = _qkv(rng, 2, 32, 4, 2, 16)
            cases.append(dict(q=q, k=k, v=v, sp=sp, causal=causal))
            fn = jax.shard_map(partial(ring_attention, axis_name="sp", causal=causal),
                               mesh=Mesh(np.asarray(jax.devices()[:sp]), ("sp",)),
                               in_specs=(P(None, "sp", None, None),) * 3,
                               out_specs=P(None, "sp", None, None), check_vma=False)
            jax_out.append(np.asarray(jax.jit(fn)(q, k, v)))
            i = np.arange(32)
            mask = (i[:, None] >= i[None, :])[None] if causal else None
            dense.append(np.asarray(dot_attention(q, k, v, mask=mask, precision="float32")))
        q, k, v = _qkv(rng, 1, 32, 4, 2, 8)
        ids = _ids()
        fn = jax.shard_map(partial(ring_packed_attention, axis_name="sp"),
                           mesh=Mesh(np.asarray(jax.devices()[:4]), ("sp",)),
                           in_specs=(P(None, "sp"),) * 3 + (P("sp"),) * 3,
                           out_specs=P(None, "sp"), check_vma=False)
        packed_jax = np.asarray(jax.jit(fn)(q, k, v, *ids))
        packed_dense = np.asarray(dot_attention(q, k, v, mask=train_packed_mask(*ids)[None],
                                                precision="float32"))
    for chunk in PACKED:
        cases.append(dict(q=q, k=k, v=v, sp=4, ids=ids, q_chunk=chunk))
        jax_out.append(packed_jax)
        dense.append(packed_dense)
    got = run("ring_cases", 4, tmp_path_factory.mktemp("ring"), cases=cases)
    for r in got[1:]:
        for a, b in zip(r, got[0]):
            np.testing.assert_array_equal(a, b)
    return got[0], jax_out, dense


@pytest.mark.parametrize("case", range(len(RING)), ids=[f"causal={c}-sp={s}" for c, s in RING])
def test_ring_attention_matches_jax_and_dense(rings, case):
    got, jax_out, dense = rings
    assert_close_live(got[case], jax_out[case], floor=1e-3, rtol=TOL, atol=TOL, name="vs JAX")
    assert_close_live(got[case], dense[case], floor=1e-3, rtol=TOL, atol=TOL, name="vs dense")


@pytest.mark.parametrize("chunk", PACKED)
def test_ring_packed_attention_matches_jax_and_dense(rings, chunk):
    got, jax_out, dense = rings
    case = len(RING) + PACKED.index(chunk)
    assert_close_live(got[case], jax_out[case], floor=1e-3, rtol=TOL, atol=TOL, name="vs JAX")
    assert_close_live(got[case], dense[case], floor=1e-3, rtol=TOL, atol=TOL, name="vs dense")


def test_context_parallel_train_gradients_match_dense(tmp_path):
    jcfg, cfg = configs()
    jp = jax_params(jcfg)
    jb = jax_batch(jcfg, n=1, seq_len=256)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(2), jb.vae_patches.shape))
    with jax.default_matmul_precision("float32"):
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jstep.compute_losses(
            jstep.freeze_stop_gradient(p), jcfg, jb, noise, ce_weight=1.0,
            mse_weight=1.0)[0]))(jp)
    want = jax_leaves(grads)
    got = run("cp_grads", 4, tmp_path, shape=(1, 4, 1), axis="fsdp",
              params=jax.tree.map(np.asarray, jp), cfg=cfg,
              batch={k: np.asarray(v) for k, v in vars(jb).items()}, noise=noise)[0]
    assert abs(got["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    for path, g in got["grads"].items():
        ref = want[tuple(int(p) if p.isdigit() else p for p in path.split("/"))]
        if g is None:
            assert not np.abs(ref).max(), path
            continue
        assert rel_err(g, ref) <= 1e-4, (path, rel_err(g, ref))
