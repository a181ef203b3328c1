"""bagel_tpu_torch's data pipeline vs bagel_tpu's: the same corpora
(a T2I parquet, an SFT jsonl with images, an edit-chain parquet) through
both packages' datasets, SequenceBuilder / finalize, PackedBatchIterator,
make_synthetic_batch and stack_batches give identical arrays (exact); the
native span expansion equals its Python fallback; the VAE encode fills the
latent rows. Video samples: tests/test_torch_video.py."""

import dataclasses
import io
import json
import random

import numpy as np
import pytest
import torch
from PIL import Image

from bagel_tpu.configs import micro_bagel as jmicro_bagel
from bagel_tpu.data import datasets as jds
from bagel_tpu.data import packing as jpk
from bagel_tpu.data.tokenizer import MockTokenizer as JMockTokenizer
from bagel_tpu.data.transforms import ImageTransform as JImageTransform
from bagel_tpu_torch import native as tnative
from bagel_tpu_torch.configs import micro_bagel
from bagel_tpu_torch.data import datasets as tds
from bagel_tpu_torch.data import packing as tpk
from bagel_tpu_torch.data.tokenizer import MockTokenizer
from bagel_tpu_torch.data.transforms import ImageTransform
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)


def _png(rng, w, h):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8), "RGB").save(buf, "PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq

    root = tmp_path_factory.mktemp("packing_data")
    rng = np.random.default_rng(0)
    (root / "t2i").mkdir()
    rows = [{"image": _png(rng, 40 + 8 * (i % 3), 48),
             "captions": json.dumps({"default": f"an image number {i}", "b": f"pic {i}"})}
            for i in range(8)]
    pq.write_table(pa.Table.from_pylist(rows), root / "t2i" / "part0.parquet", row_group_size=4)
    (root / "vlm" / "images").mkdir(parents=True)
    lines = []
    for i in range(6):
        (root / "vlm" / "images" / f"img{i}.png").write_bytes(_png(rng, 56, 42))
        lines.append(json.dumps({"image": f"img{i}.png", "conversations": [
            {"from": "human", "value": f"<image>\nwhat is {i}?"},
            {"from": "gpt", "value": f"it is the number {i}"}]}))
    (root / "vlm" / "conv.jsonl").write_text("\n".join(lines))
    (root / "edit").mkdir()
    rows = [{"image_list": [_png(rng, 48, 48) for _ in range(3)],
             "instruction_list": [[f"make it {j}" for j in range(2)]] * 2} for _ in range(4)]
    pq.write_table(pa.Table.from_pylist(rows), root / "edit" / "part0.parquet", row_group_size=2)
    return root


def _datasets(mod, tf_cls, tok, root):
    cfg = micro_bagel()
    vae_tf = tf_cls(64, 16, cfg.latent_downsample, max_pixels=64 * 64)
    vit_tf = tf_cls(56, 28, cfg.vit.patch_size, max_pixels=56 * 56)
    return [
        mod.T2IIterableDataset("t2i_pretrain", vae_tf, tok, [str(root / "t2i")], [1]),
        mod.SftJSONLIterableDataset("vlm_sft", vit_tf, tok, [str(root / "vlm" / "conv.jsonl")],
                                    [str(root / "vlm" / "images")]),
        mod.UnifiedEditIterableDataset("unified_edit", vae_tf, tok, vit_tf, [str(root / "edit")]),
    ]


def _pcfg(mod, **kw):
    cfg = micro_bagel()
    return mod.PackerConfig(vae_image_downsample=cfg.latent_downsample,
                            max_latent_size=cfg.max_latent_size,
                            vit_patch_size=cfg.vit.patch_size,
                            max_num_patch_per_side=cfg.vit_max_num_patch_per_side, **kw)


def _assert_samples_equal(a, b):
    assert a["sequence_plan"] == b["sequence_plan"]
    assert a["text_ids_list"] == b["text_ids_list"]
    assert a["num_tokens"] == b["num_tokens"] and a["data_indexes"] == b["data_indexes"]
    assert len(a["image_tensor_list"]) == len(b["image_tensor_list"])
    for x, y in zip(a["image_tensor_list"], b["image_tensor_list"]):
        np.testing.assert_array_equal(x, y)


def _assert_batches_equal(jb, tb):
    for f in dataclasses.fields(jb):
        want, got = np.asarray(getattr(jb, f.name)), np.asarray(getattr(tb, f.name))
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


def test_datasets_yield_the_same_samples(corpora):
    jtok, ttok = JMockTokenizer(128), MockTokenizer(128)
    for jd, td in zip(_datasets(jds, JImageTransform, jtok, corpora),
                      _datasets(tds, ImageTransform, ttok, corpora)):
        random.seed(3)
        want = [s for _, s in zip(range(5), iter(jd))]
        random.seed(3)
        got = [s for _, s in zip(range(5), iter(td))]
        for a, b in zip(got, want):
            _assert_samples_equal(a, b)


@pytest.mark.parametrize("reweight", [False, True])
def test_packer_gives_identical_batches(corpora, reweight):
    """Three groups (one mandatory), the overflow buffer and the per-sample
    cap in play: every field of every batch, the raw VAE images and the
    data indexes are identical."""
    streams = []
    for mod, tf_cls, tok, pk in ((jds, JImageTransform, JMockTokenizer(128), jpk),
                                 (tds, ImageTransform, MockTokenizer(128), tpk)):
        random.seed(11)
        its = [iter(d) for d in _datasets(mod, tf_cls, tok, corpora)]
        packer = pk.PackedBatchIterator(
            _pcfg(pk, ce_loss_reweighting=reweight), its, [0.5, 0.3, 0.2], [True, False, False],
            tok.new_token_ids, expected_num_tokens=300, max_num_tokens=400,
            max_num_tokens_per_sample=380, prefer_buffer_before=200, max_buffer_size=3,
            seed=5, finalize_kwargs=dict(vit_patch_dim=588, patch_latent_dim=16,
                                         as_device=False))
        streams.append([h for _, h in zip(range(3), iter(packer))])
    for jh, th in zip(*streams):
        _assert_batches_equal(jh.batch, th.batch)
        assert th.vae_latent_shapes == jh.vae_latent_shapes
        assert th.vae_token_counts == jh.vae_token_counts and th.data_indexes == jh.data_indexes
        for x, y in zip(th.vae_images, jh.vae_images):
            np.testing.assert_array_equal(x, y)
    # as_device=True: the same values as CPU tensors
    assert isinstance(streams[1][0].batch.position_ids, np.ndarray)


def test_builder_and_finalize_buckets(corpora):
    tok = MockTokenizer(128)
    td = _datasets(tds, ImageTransform, tok, corpora)
    random.seed(0)
    samples = [next(iter(td[0])), next(iter(td[1])), next(iter(td[2]))]
    outs = []
    for pk, t in ((jpk, JMockTokenizer(128)), (tpk, tok)):
        b = pk.SequenceBuilder(_pcfg(pk), t.new_token_ids)
        for s in samples:
            b.pack_sample(dict(s))
        outs.append(pk.finalize(b, seq_bucket=128, vit_patch_dim=588, patch_latent_dim=16,
                                as_device=False))
    _assert_batches_equal(outs[0].batch, outs[1].batch)
    th = tpk.finalize(b, seq_bucket=128, vit_patch_dim=588, patch_latent_dim=16)
    assert torch.is_tensor(th.batch.document_id)
    np.testing.assert_array_equal(th.batch.document_id.numpy(), outs[1].batch.document_id)


def test_synthetic_batches_and_stacking():
    jcfg, cfg = jmicro_bagel(), micro_bagel()
    ja = [jpk.make_synthetic_batch(jcfg, np.random.default_rng(0), seq_len=s, n_text=n)
          for s, n in ((256, 16), (512, 48))]
    ta = [tpk.make_synthetic_batch(cfg, np.random.default_rng(0), seq_len=s, n_text=n)
          for s, n in ((256, 16), (512, 48))]
    for j, t in zip(ja, ta):
        _assert_batches_equal(j, t)
    _assert_batches_equal(jpk.stack_batches(ja), tpk.stack_batches(ta))
    _assert_batches_equal(jpk.stack_batches(ja[:1]), tpk.stack_batches(ta[:1]))


def test_pack_spans_native_equals_fallback(monkeypatch):
    assert tnative.native_available()
    rng = np.random.default_rng(1)
    spans, off = [], 0
    for i in range(40):
        n = int(rng.integers(1, 30))
        spans.append((1 + i // 5, int(rng.integers(-1, 9)), int(rng.integers(-1, 9)), n,
                      int(rng.integers(0, 2)), int(rng.integers(0, 50)), off))
        off += n
    spans = np.asarray(spans, np.int64)
    native = tnative.pack_spans(spans, off + 7)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    fallback = tnative.pack_spans(spans, off + 7)
    for a, b in zip(native, fallback):
        np.testing.assert_array_equal(a, b)
    assert native[0][-7:].max() == 0 and native[1][-7:].min() == -1


def test_encode_vae_images_fills_the_latent_rows(corpora):
    from bagel_tpu_torch.models.bagel import init_bagel_params, patchify_latent
    from bagel_tpu_torch.models.vae import vae_encode

    cfg = micro_bagel()
    params = init_bagel_params(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    tok = MockTokenizer(128)
    b = tpk.SequenceBuilder(_pcfg(tpk), tok.new_token_ids)
    random.seed(0)
    b.pack_sample(next(iter(_datasets(tds, ImageTransform, tok, corpora)[0])))
    host = tpk.finalize(b, seq_bucket=128, vit_patch_dim=588,
                        patch_latent_dim=cfg.patch_latent_dim, as_device=False)
    batch = tpk.encode_vae_images(params["vae"], cfg, host, torch.Generator().manual_seed(4),
                                  "cpu")
    z = vae_encode(params["vae"], cfg.vae, torch.tensor(host.vae_images[0])[None],
                   generator=torch.Generator().manual_seed(4))[0]
    want = patchify_latent(z, cfg.latent_patch_size)
    torch.testing.assert_close(batch.vae_patches[: want.shape[0]], want)
    assert not batch.vae_patches[want.shape[0]:].any()
    assert batch.document_id.device.type == "cpu" and torch.is_tensor(batch.position_ids)
