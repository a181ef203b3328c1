"""bagel_tpu_torch's packed training forward vs bagel_tpu's (fp32 both
sides, JAX's B3 in interpret mode), on the micro model at two layers.

Per-element `ce`, `mse` and their weights, and the gradient of the summed
weighted losses per leaf (to its largest entry), within 1e-4: on
`make_synthetic_batch` and on a packed batch from the packer (padding, two
documents, the sink slot), over the dense-mask, `attn_chunk` and
`sparse_block` attention paths with `freeze_und` off and on (the gradient,
not only the loss, is compared: a missed detach changes the und gradients
while the loss still matches). The port's three remat modes give equal
gradients. The parallel paths are held in tests/test_torch_ring.py,
test_torch_expert.py and test_torch_pipeline.py.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch
from asserts import assert_close_live

import jax
import jax.numpy as jnp

from bagel_tpu.data import packing as jpk
from bagel_tpu.data.tokenizer import MockTokenizer as JMockTokenizer
from bagel_tpu.models.bagel import bagel_forward_train as jforward
from bagel_tpu_torch.models.bagel import bagel_forward_train
from torch_train_util import (
    configs,
    jax_leaves,
    jax_params,
    paths,
    rel_err,
    to_torch_batch,
    torch_params,
)

TOL = 1e-4


def _packed_batch(jcfg):
    """Two samples through the JAX packer: text (CE loss) + a ViT image, and
    text + a noised VAE image (MSE loss); seq bucket 128 leaves padding."""
    tok = JMockTokenizer(jcfg.llm.vocab_size)
    rng = np.random.default_rng(2)
    plan = lambda *items: [dict(type=t, enable_cfg=0, loss=l, special_token_loss=0,
                                special_token_label=None) for t, l in items]
    samples = [
        dict(image_tensor_list=[rng.uniform(-1, 1, (28, 42, 3)).astype(np.float32)],
             text_ids_list=[tok.encode("what is in it"), tok.encode("a cat on a mat")],
             sequence_plan=plan(("text", 0), ("vit_image", 0), ("text", 1)), num_tokens=20),
        dict(image_tensor_list=[rng.uniform(-1, 1, (16, 24, 3)).astype(np.float32)],
             text_ids_list=[tok.encode("draw a dog")],
             sequence_plan=plan(("text", 0), ("vae_image", 1)), num_tokens=30),
    ]
    pcfg = jpk.PackerConfig(text_cond_dropout_prob=0.0, vit_cond_dropout_prob=0.0,
                            vae_cond_dropout_prob=0.0,
                            vae_image_downsample=jcfg.latent_downsample,
                            max_latent_size=jcfg.max_latent_size,
                            vit_patch_size=jcfg.vit.patch_size,
                            max_num_patch_per_side=jcfg.vit_max_num_patch_per_side)
    b = jpk.SequenceBuilder(pcfg, tok.new_token_ids, rng=random.Random(0),
                            np_rng=np.random.default_rng(0))
    for s in samples:
        b.pack_sample(s)
    host = jpk.finalize(b, seq_bucket=128, text_bucket=32, vit_bucket=32, vae_bucket=32,
                        ce_bucket=32, vit_patch_dim=jcfg.vit.patch_dim,
                        patch_latent_dim=jcfg.patch_latent_dim, as_device=False)
    latents = np.random.default_rng(3).standard_normal(host.batch.vae_patches.shape)
    return dataclasses.replace(host.batch, vae_patches=latents.astype(np.float32))


@pytest.fixture(scope="module")
def batches():
    jcfg, _ = configs(num_hidden_layers=2)
    synth = jpk.make_synthetic_batch(jcfg, np.random.default_rng(0), seq_len=128, n_text=24,
                                     vit_hw=(28, 28), vae_hw=(16, 16))
    return {"synthetic": jax.tree.map(np.asarray, synth), "packed": _packed_batch(jcfg)}


def _weighted(o):
    total = (o["ce"] * o["ce_weight"]).sum()
    if "mse" in o:
        total = total + (o["mse"].mean(-1) * o["mse_weight"]).sum()
    return total


CASES = [  # (batch, attention, freeze_und)
    ("synthetic", "dense", False),
    ("synthetic", "attn_chunk", True),
    ("synthetic", "sparse_block", False),
    ("packed", "dense", True),
    ("packed", "sparse_block", True),
    ("packed", "attn_chunk", False),
]


@pytest.mark.parametrize("which,attn,freeze", CASES)
def test_forward_and_gradients_match_jax(batches, which, attn, freeze):
    jcfg, cfg = configs(num_hidden_layers=2, freeze_und=freeze)
    jb = batches[which]
    kw = {"dense": {}, "attn_chunk": {"attn_chunk": 64}, "sparse_block": {"sparse_block": 64}}[attn]
    jp = jax_params(jcfg, seed=3)
    noise = np.random.default_rng(5).standard_normal(jb.vae_patches.shape).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        def loss(p):
            o = jforward(p, jcfg, jb, jnp.asarray(noise), **kw)
            return _weighted(o), o
        (_, jo), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    params = torch_params(jp)
    leaves = paths(params)
    for t in leaves.values():
        t.requires_grad_(True)
    o = bagel_forward_train(params, cfg, to_torch_batch(jb), torch.tensor(noise), **kw)
    grads = torch.autograd.grad(_weighted(o), list(leaves.values()), allow_unused=True)
    for k in ("ce", "ce_weight", "mse", "mse_weight"):
        assert_close_live(o[k].detach().numpy(), np.asarray(jo[k]), rtol=TOL, atol=TOL, name=k)
    want = jax_leaves(jg)
    for (path, _), g in zip(leaves.items(), grads):
        ref = want[path]
        if not np.abs(ref).max():
            assert g is None or not g.abs().max(), path
            continue
        assert rel_err(g.numpy(), ref) <= TOL, (path, rel_err(g.numpy(), ref))
    if freeze:  # und-only leaves get nothing
        for path in (("llm", "layers", "mlp", "down"), ("llm", "final_norm")):
            assert not np.abs(want[path]).max()


def test_remat_modes_give_equal_gradients(batches):
    jcfg, cfg = configs(num_hidden_layers=2)
    jb = to_torch_batch(batches["packed"])
    noise = torch.tensor(np.random.default_rng(5).standard_normal(jb.vae_patches.shape),
                         dtype=torch.float32)
    params = torch_params(jax_params(jcfg, seed=3))
    leaves = list(paths(params).values())
    for t in leaves:
        t.requires_grad_(True)
    got = {}
    for remat in ("full", "dots", "none"):
        o = bagel_forward_train(params, cfg, jb, noise, sparse_block=64, remat=remat)
        got[remat] = torch.autograd.grad(_weighted(o), leaves, allow_unused=True)
    for remat in ("dots", "none"):
        for a, b in zip(got["full"], got[remat]):
            assert (a is None) == (b is None)
            if a is not None:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        bagel_forward_train(params, cfg, jb, noise, remat="some")
