"""Video samples: bagel_tpu_torch.data.video against bagel_tpu.data.video,
and a video sample through both packages' datasets and packer.

Bars (all exact): `sample_frame_indexes` over a grid of (frames, fps, n,
max_fps); `FrameSampler` on a directory of frames gives the same indexes
and pixels, and a video file without decord raises RuntimeError in both;
an SFT video sample ('<video>' in the conversation, frames as images)
yields and packs identically, and one without a frame sampler is skipped
as in JAX; `_add_video`'s plan (split flags, frame deltas) packs into the
same tokens, positions and latent ids."""

import itertools
import json
import random

import numpy as np
import pytest
from PIL import Image

from bagel_tpu.data import datasets as jds
from bagel_tpu.data import packing as jpk
from bagel_tpu.data import video as jvideo
from bagel_tpu.data.tokenizer import MockTokenizer as JMockTokenizer
from bagel_tpu.data.transforms import ImageTransform as JImageTransform
from bagel_tpu_torch.data import datasets as tds
from bagel_tpu_torch.data import packing as tpk
from bagel_tpu_torch.data import video as tvideo
from bagel_tpu_torch.data.tokenizer import MockTokenizer
from bagel_tpu_torch.data.transforms import ImageTransform

from test_torch_packing import _assert_batches_equal, _assert_samples_equal, _pcfg
from torch_test_env import port_limits  # noqa: F401 (autouse: time limit, torch threads)

GRID = list(itertools.product([1, 2, 5, 16, 97, 301], [0.5, 1.0, 24.0, 29.97],
                              [1, 4, 8, 16], [0.5, 2.0, 4.0]))


def test_sample_frame_indexes_match_jax():
    for frames, fps, n, max_fps in GRID:
        want = jvideo.sample_frame_indexes(frames, fps, n, max_fps)
        got = tvideo.sample_frame_indexes(frames, fps, n, max_fps)
        assert got == want, (frames, fps, n, max_fps)
        assert all(0 <= i < frames for i in got)
    assert len({len(tvideo.sample_frame_indexes(*g)) for g in GRID}) > 4


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two directories of frames (13 and 3 PNG/JPEG frames, 40 x 48) and a
    video file name that no backend here can read."""
    root = tmp_path_factory.mktemp("video")
    rng = np.random.default_rng(0)
    for name, n in (("clip_a", 13), ("clip_b", 3)):
        (root / name).mkdir()
        for i in range(n):
            arr = rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)
            ext = "png" if i % 4 else "jpg"
            Image.fromarray(arr).save(root / name / f"frame_{i:04d}.{ext}")
        (root / name / "notes.txt").write_text("not a frame")
    (root / "clip.mp4").write_bytes(b"\x00" * 64)
    return root


@pytest.mark.parametrize("num_frames,max_fps", [(8, 2.0), (4, 0.5), (16, 4.0), (1, 2.0)])
def test_frame_sampler_matches_jax(clips, num_frames, max_fps):
    for clip in ("clip_a", "clip_b"):
        jframes, jidx = jvideo.FrameSampler(num_frames, max_fps).sample_with_indexes(
            str(clips / clip))
        tframes, tidx = tvideo.FrameSampler(num_frames, max_fps).sample_with_indexes(
            str(clips / clip))
        assert tidx == jidx and len(tframes) == len(jframes) == len(jidx)
        for a, b in zip(tframes, jframes):
            assert a.mode == b.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert [np.asarray(f).shape for f in tvideo.FrameSampler(num_frames, max_fps)(
            str(clips / clip))] == [(40, 48, 3)] * len(tidx)


def test_video_file_without_decord_raises(clips):
    for mod in (jvideo, tvideo):
        with pytest.raises(RuntimeError, match="no video decoder"):
            mod.FrameSampler().sample_with_indexes(str(clips / "clip.mp4"))


def _sft(mod, tf_cls, tok, jsonl, root, sampler):
    return mod.SftJSONLIterableDataset(
        "vlm_sft", tf_cls(56, 28, 14, max_pixels=56 * 56), tok, [str(jsonl)], [str(root)],
        frame_sampler=sampler)


def test_sft_video_sample_matches_jax(clips, tmp_path):
    """'<video>' becomes one '<image>' a frame, the frames the sample's
    images: the same sample and the same packed batch as JAX's."""
    jsonl = tmp_path / "v.jsonl"
    jsonl.write_text("\n".join(json.dumps(r) for r in [
        {"video": "clip_a", "conversations": [
            {"from": "human", "value": "<video>\nwhat happens here?"},
            {"from": "gpt", "value": "the frames change"}]},
        {"video": "clip_b", "conversations": [
            {"from": "human", "value": "describe <video> briefly"},
            {"from": "gpt", "value": "three frames"}]}]))
    samples, batches = [], []
    for mod, tf_cls, tok, vid, pk in (
            (jds, JImageTransform, JMockTokenizer(128), jvideo, jpk),
            (tds, ImageTransform, MockTokenizer(128), tvideo, tpk)):
        ds = _sft(mod, tf_cls, tok, jsonl, clips, vid.FrameSampler(4, 2.0))
        random.seed(3)
        got = [s for _, s in zip(range(2), iter(ds))]
        samples.append(got)
        b = pk.SequenceBuilder(_pcfg(pk), tok.new_token_ids)
        for s in got:
            b.pack_sample(dict(s))
        batches.append(pk.finalize(b, seq_bucket=128, vit_patch_dim=588, patch_latent_dim=16,
                                   as_device=False))
    for a, b in zip(samples[1], samples[0]):
        _assert_samples_equal(a, b)
    n_images = [sum(p["type"] == "vit_image" for p in s["sequence_plan"]) for s in samples[1]]
    assert sorted(n_images) == [3, 4]
    _assert_batches_equal(batches[0].batch, batches[1].batch)


def test_video_sample_without_sampler_is_skipped(clips, tmp_path):
    """As in JAX: the RuntimeError is printed and the stream goes on with
    the next sample."""
    (tmp_path / "img.png").write_bytes((clips / "clip_a" / "frame_0001.png").read_bytes())
    jsonl = tmp_path / "v.jsonl"
    jsonl.write_text("\n".join(json.dumps(r) for r in [
        {"video": "clip_a", "conversations": [{"from": "human", "value": "<video> what?"},
                                              {"from": "gpt", "value": "x"}]},
        {"image": "img.png", "conversations": [{"from": "human", "value": "<image> what?"},
                                               {"from": "gpt", "value": "y"}]}]))
    firsts = []
    for mod, tf_cls, tok in ((jds, JImageTransform, JMockTokenizer(128)),
                             (tds, ImageTransform, MockTokenizer(128))):
        ds = _sft(mod, tf_cls, tok, jsonl, tmp_path, None)
        random.seed(0)
        firsts.append(next(iter(ds)))
    _assert_samples_equal(firsts[1], firsts[0])
    assert firsts[1]["data_indexes"]["data_indexes"] == 1


class _Interleaved:
    """The smallest InterleavedBase of each package: a transform, a ViT
    transform and a tokenizer."""

    @staticmethod
    def make(mod, tf_cls, tok):
        base = mod.InterleavedBase.__new__(mod.InterleavedBase)
        base.transform = tf_cls(64, 16, 4, max_pixels=64 * 64)
        base.vit_transform = tf_cls(56, 28, 14, max_pixels=56 * 56)
        base.tokenizer = tok
        return base


@pytest.mark.parametrize("need_loss", [True, False])
def test_add_video_plan_packs_like_jax(clips, need_loss):
    """A video2video sample: text, the clip's frames through `_add_video`
    (split flags, frame deltas from the sampled indexes), then packed."""
    samples, batches = [], []
    for mod, tf_cls, tok, vid, pk in (
            (jds, JImageTransform, JMockTokenizer(128), jvideo, jpk),
            (tds, ImageTransform, MockTokenizer(128), tvideo, tpk)):
        base = _Interleaved.make(mod, tf_cls, tok)
        frames, idx = vid.FrameSampler(5, 4.0).sample_with_indexes(str(clips / "clip_a"))
        data = base._init_data()
        data = base._add_text(data, "continue the clip", need_loss=False)
        data = base._add_video(data, frames, idx, need_loss=need_loss,
                               need_vae=not need_loss)
        data["data_indexes"] = {"data_indexes": 0, "worker_id": 0, "dataset_name": "v"}
        samples.append(data)
        b = pk.SequenceBuilder(_pcfg(pk), tok.new_token_ids)
        b.pack_sample(dict(data))
        batches.append(pk.finalize(b, seq_bucket=128, vit_patch_dim=588, patch_latent_dim=16,
                                   as_device=False))
    _assert_samples_equal(samples[1], samples[0])
    deltas = [p.get("frame_delta") for p in samples[1]["sequence_plan"][1:]]
    assert deltas[:-1] == list(np.diff(idx)) and deltas[-1] is None and len(deltas) == 5
    _assert_batches_equal(batches[0].batch, batches[1].batch)
    assert len(set(batches[1].batch.position_ids.tolist())) > 2
