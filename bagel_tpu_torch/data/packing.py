"""NaViT sequence packing for training (port of bagel_tpu/data/packing.py).

Re-implements the reference PackedDataset semantics (data/dataset_base.py)
for static-shape TPU batches:

- `SequenceBuilder.pack_sample` walks a sample's sequence_plan exactly like
  pack_sequence (dataset_base.py:306-475): CFG condition dropout per
  modality, <|im_start|>/<|im_end|>/<|vision_start|>/<|vision_end|>
  bracketing, per-split attention modes (causal/full/noise), one shared RoPE
  position per image (+frame_delta for video), sigmoid-space flow timestep
  per loss image (-inf => clean), CE loss with len2weight reweighting.
- `PackedBatchIterator` mirrors the packing loop (dataset_base.py:238-304):
  weighted group sampling with mandatory groups guaranteed per batch, greedy
  fill to expected_num_tokens with a max_num_tokens cap, an overflow buffer,
  and per-sample length caps.
- `finalize` pads the dynamic lists into a PackedTrainBatch with bucketed
  static shapes (slot seq_len-1 is the scatter sink; document_id 0 marks
  padding) — replacing the reference's to_tensor + flex padding
  (dataset_base.py:187-236).
- VAE images ride along as raw arrays; `encode_vae_images` runs the frozen
  VAE on the device per image and fills vae_patches (the reference encodes
  inside the train loop, pretrain_unified_navit.py:686).

Everything but `encode_vae_images` is numpy and host Python, so packing
workers never touch the device; `finalize(as_device=True)` returns torch
tensors (on the CPU: the loader moves them to the device).
"""

from __future__ import annotations

import dataclasses
import random as pyrandom
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from bagel_tpu_torch.configs import BagelConfig
from bagel_tpu_torch.data.transforms import len2weight, patchify_image
from bagel_tpu_torch.models.bagel import PackedTrainBatch
from bagel_tpu_torch.ops.embeds import (
    flattened_position_ids_extrapolate,
    flattened_position_ids_interpolate,
)

NEG_INF = float("-inf")


@dataclasses.dataclass
class PackerConfig:
    """DataConfig equivalent (dataset_base.py:23-42)."""

    text_cond_dropout_prob: float = 0.1
    vit_cond_dropout_prob: float = 0.4
    vae_cond_dropout_prob: float = 0.1
    vae_image_downsample: int = 16
    max_latent_size: int = 32
    vit_patch_size: int = 14
    max_num_patch_per_side: int = 70
    interpolate_pos: bool = False
    # len2weight CE reweighting (pretrain flag ce_loss_reweighting, off by
    # default — pretrain_unified_navit.py:700-707)
    ce_loss_reweighting: bool = False


class SequenceBuilder:
    """Accumulates one packed multi-sample sequence (sequence_status
    equivalent, dataset_base.py:161-185)."""

    def __init__(self, cfg: PackerConfig, special_tokens: dict,
                 rng: Optional[pyrandom.Random] = None,
                 np_rng: Optional[np.random.Generator] = None):
        self.cfg = cfg
        self.sp = special_tokens
        self.rng = rng or pyrandom.Random(0)
        self.np_rng = np_rng or np.random.default_rng(0)
        self._pos_fn = (
            flattened_position_ids_interpolate
            if cfg.interpolate_pos else flattened_position_ids_extrapolate
        )
        self.curr = 0
        self.split_counter = 0
        self.doc_counter = 0
        # packed lists
        self.text_ids: List[int] = []
        self.text_idx: List[int] = []
        # sequence metadata as compact span descriptors expanded by the
        # native packer at finalize (bagel_tpu/native/packing.cc):
        # (doc, fan, noise, n_tokens, rope_mode, rope_start, out_offset)
        self.spans: List[tuple] = []
        self.ce_idx: List[int] = []
        self.ce_labels: List[int] = []
        self.ce_weight: List[float] = []
        self.vit_patches: List[np.ndarray] = []
        self.vit_pos_ids: List[np.ndarray] = []
        self.vit_seg_ids: List[int] = []
        self.vit_idx: List[int] = []
        self.vit_image_count = 0
        self.vae_images: List[np.ndarray] = []
        self.vae_latent_shapes: List[Tuple[int, int]] = []
        self.vae_pos_ids: List[np.ndarray] = []
        self.vae_idx: List[int] = []
        self.vae_timesteps: List[float] = []
        self.mse_weight: List[float] = []
        self.sample_lens: List[int] = []
        self.data_indexes: List[dict] = []

    # -- split bookkeeping --------------------------------------------------

    def _begin_split(self, mode: str) -> Tuple[int, int]:
        """Returns (fan, noise) split ids for tokens of this split."""
        sid = self.split_counter
        self.split_counter += 1
        fan = sid if mode in ("full", "noise") else -1
        noi = sid if mode == "noise" else -1
        return fan, noi

    def _push_meta(self, n: int, doc: int, fan: int, noi: int, pos):
        """Record one split's metadata; pos is an int (constant rope id for
        image splits) or a range start tuple ('seq', start)."""
        offset = self.curr - n
        if isinstance(pos, int):
            self.spans.append((doc, fan, noi, n, 1, pos, offset))
        else:
            self.spans.append((doc, fan, noi, n, 0, pos[1], offset))

    # -- pack one sample (pack_sequence parity) ------------------------------

    def pack_sample(self, sample: dict):
        image_list = list(sample["image_tensor_list"])
        text_list = list(sample["text_ids_list"])
        plan = sample["sequence_plan"]
        doc = self.doc_counter + 1
        self.doc_counter += 1

        curr_rope = 0
        sample_len = 0
        split_len = 0
        split_mode = None
        split_fan = split_noi = -1

        for item in plan:
            split_start = item.get("split_start", True)
            if split_start:
                split_len = 0

            if item["type"] == "text":
                text_ids = text_list.pop(0)
                if item["enable_cfg"] == 1 and self.rng.random() < self.cfg.text_cond_dropout_prob:
                    continue
                split_fan, split_noi = self._begin_split("causal")
                shifted = [self.sp["bos_token_id"]] + list(text_ids)
                start = self.curr
                self.text_ids.extend(shifted)
                self.text_idx.extend(range(start, start + len(shifted)))
                if item["loss"] == 1:
                    w = (
                        len2weight(len(shifted))
                        if self.cfg.ce_loss_reweighting else 1.0
                    )
                    self.ce_idx.extend(range(start, start + len(shifted)))
                    self.ce_weight.extend([w] * len(shifted))
                    self.ce_labels.extend(list(text_ids) + [self.sp["eos_token_id"]])
                self.curr += len(shifted)
                split_len += len(shifted)

                self.text_ids.append(self.sp["eos_token_id"])
                self.text_idx.append(self.curr)
                if item.get("special_token_loss") == 1:
                    self.ce_idx.append(self.curr)
                    self.ce_weight.append(1.0)
                    self.ce_labels.append(item["special_token_label"])
                self.curr += 1
                split_len += 1
                self._push_meta(
                    split_len, doc, split_fan, split_noi, ("seq", curr_rope)
                )
                curr_rope += split_len
                sample_len += split_len

            elif item["type"] == "vit_image":
                image = image_list.pop(0)
                if item["enable_cfg"] == 1 and self.rng.random() < self.cfg.vit_cond_dropout_prob:
                    curr_rope += 1
                    continue
                split_fan, split_noi = self._begin_split("full")
                self.text_ids.append(self.sp["start_of_image"])
                self.text_idx.append(self.curr)
                self.curr += 1
                split_len += 1

                patches = patchify_image(image, self.cfg.vit_patch_size)
                n = patches.shape[0]
                self.vit_idx.extend(range(self.curr, self.curr + n))
                self.vit_patches.append(patches)
                self.vit_image_count += 1
                self.vit_seg_ids.extend([self.vit_image_count] * n)
                self.vit_pos_ids.append(
                    np.asarray(
                        self._pos_fn(
                            image.shape[0], image.shape[1],
                            self.cfg.vit_patch_size,
                            self.cfg.max_num_patch_per_side,
                        )
                    )
                )
                self.curr += n
                split_len += n

                self.text_ids.append(self.sp["end_of_image"])
                self.text_idx.append(self.curr)
                if item.get("special_token_loss") == 1:
                    self.ce_idx.append(self.curr)
                    self.ce_weight.append(1.0)
                    self.ce_labels.append(item["special_token_label"])
                self.curr += 1
                split_len += 1
                self._push_meta(split_len, doc, split_fan, split_noi, curr_rope)
                curr_rope += 1
                sample_len += split_len

            elif item["type"] == "vae_image":
                image = image_list.pop(0)
                if item["enable_cfg"] == 1 and self.rng.random() < self.cfg.vae_cond_dropout_prob:
                    curr_rope += 1
                    continue
                if split_start:
                    mode = (
                        "noise"
                        if item["loss"] == 1 and "frame_delta" not in item
                        else "full"
                    )
                    split_fan, split_noi = self._begin_split(mode)

                self.text_ids.append(self.sp["start_of_image"])
                self.text_idx.append(self.curr)
                self.curr += 1
                split_len += 1

                down = self.cfg.vae_image_downsample
                h, w = image.shape[0] // down, image.shape[1] // down
                n = h * w
                self.vae_images.append(image)
                self.vae_latent_shapes.append((h, w))
                self.vae_pos_ids.append(
                    np.asarray(
                        self._pos_fn(
                            image.shape[0], image.shape[1], down,
                            self.cfg.max_latent_size,
                        )
                    )
                )
                self.vae_idx.extend(range(self.curr, self.curr + n))
                if item["loss"] == 1:
                    if item.get("split_start", True):
                        timestep = float(self.np_rng.standard_normal())
                    self.mse_weight.extend([1.0] * n)
                else:
                    timestep = NEG_INF
                    self.mse_weight.extend([0.0] * n)
                self.vae_timesteps.extend([timestep] * n)
                self.curr += n
                split_len += n

                self.text_ids.append(self.sp["end_of_image"])
                self.text_idx.append(self.curr)
                if item.get("special_token_loss") == 1:
                    self.ce_idx.append(self.curr)
                    self.ce_weight.append(1.0)
                    self.ce_labels.append(item["special_token_label"])
                self.curr += 1
                split_len += 1
                self._push_meta(split_len, doc, split_fan, split_noi, curr_rope)
                if "frame_delta" in item:
                    curr_rope += item["frame_delta"]
                elif item["loss"] == 0:
                    curr_rope += 1
                sample_len += split_len

        self.sample_lens.append(sample_len)
        if "data_indexes" in sample:
            self.data_indexes.append(sample["data_indexes"])


def _round_up(n: int, m: int) -> int:
    return max(m, -(-n // m) * m)


@dataclasses.dataclass
class HostBatch:
    """Finalized static arrays + raw VAE images awaiting device encode."""

    batch: PackedTrainBatch  # vae_patches left as zeros, filled on device
    vae_images: List[np.ndarray]
    vae_latent_shapes: List[Tuple[int, int]]
    vae_token_counts: List[int]
    data_indexes: List[dict]


def finalize(
    builder: SequenceBuilder,
    *,
    seq_bucket: int = 512,
    text_bucket: int = 128,
    vit_bucket: int = 256,
    vae_bucket: int = 256,
    ce_bucket: int = 128,
    vit_patch_dim: int = 588,
    patch_latent_dim: int = 64,
    as_device: bool = True,
) -> HostBatch:
    """Pad dynamic lists into static buckets (sink slot = seq_len-1).

    as_device=False keeps every array numpy (data-worker subprocesses);
    True makes them CPU tensors. The device transfer happens in the
    consuming process."""
    s = _round_up(builder.curr + 1, seq_bucket)
    sink = s - 1

    def pad_idx(idx, bucket):
        n = len(idx)
        b = _round_up(max(n, 1), bucket)
        out = np.full(b, sink, np.int32)
        out[:n] = idx
        return out

    def pad_val(vals, bucket, fill=0, dtype=np.int32):
        n = len(vals)
        b = _round_up(max(n, 1), bucket)
        out = np.full(b, fill, dtype)
        out[:n] = vals
        return out

    n_vit = len(builder.vit_idx)
    n_vae = len(builder.vae_idx)
    vit_b = _round_up(max(n_vit, 1), vit_bucket)
    vae_b = _round_up(max(n_vae, 1), vae_bucket)

    vit_patches = np.zeros((vit_b, vit_patch_dim), np.float32)
    if n_vit:
        vit_patches[:n_vit] = np.concatenate(builder.vit_patches, 0)
    vit_pos = pad_val(
        np.concatenate(builder.vit_pos_ids, 0) if n_vit else [], vit_bucket
    )
    vae_pos = pad_val(
        np.concatenate(builder.vae_pos_ids, 0) if n_vae else [], vae_bucket
    )

    from bagel_tpu_torch.native import pack_spans

    spans = np.asarray(builder.spans, np.int64).reshape(-1, 7)
    seq_doc, seq_fan, seq_noi, seq_pos = pack_spans(spans, s)
    gen_mask = np.zeros(s, bool)
    if builder.vae_idx:
        gen_mask[np.asarray(builder.vae_idx, np.int64)] = True

    conv = torch.as_tensor if as_device else np.asarray
    batch = PackedTrainBatch(
        text_ids=conv(pad_val(builder.text_ids, text_bucket)),
        text_idx=conv(pad_idx(builder.text_idx, text_bucket)),
        vit_patches=conv(vit_patches),
        vit_pos_ids=conv(vit_pos),
        vit_seg_ids=conv(pad_val(builder.vit_seg_ids, vit_bucket)),
        vit_idx=conv(pad_idx(builder.vit_idx, vit_bucket)),
        vae_patches=conv(np.zeros((vae_b, patch_latent_dim), np.float32)),
        vae_pos_ids=conv(vae_pos),
        vae_idx=conv(pad_idx(builder.vae_idx, vae_bucket)),
        vae_timesteps=conv(
            pad_val(builder.vae_timesteps, vae_bucket, NEG_INF, np.float32)
        ),
        position_ids=conv(seq_pos),
        document_id=conv(seq_doc),
        fan_id=conv(seq_fan),
        noise_id=conv(seq_noi),
        gen_mask=conv(gen_mask),
        ce_idx=conv(pad_idx(builder.ce_idx, ce_bucket)),
        ce_labels=conv(pad_val(builder.ce_labels, ce_bucket)),
        ce_weight=conv(
            pad_val(builder.ce_weight, ce_bucket, 0.0, np.float32)
        ),
        mse_weight=conv(
            pad_val(builder.mse_weight, vae_bucket, 0.0, np.float32)
        ),
    )
    return HostBatch(
        batch=batch,
        vae_images=builder.vae_images,
        vae_latent_shapes=builder.vae_latent_shapes,
        vae_token_counts=[h * w for (h, w) in builder.vae_latent_shapes],
        data_indexes=builder.data_indexes,
    )


def encode_vae_images(
    vae_params, cfg: BagelConfig, host: HostBatch, generator: torch.Generator, device,
) -> PackedTrainBatch:
    """The batch on `device` (the VAE's) with vae_patches filled by the
    frozen VAE, one image at a time, each posterior sample drawn from
    `generator` (pretrain_unified_navit.py:686 equivalent). JAX draws from
    a PRNGKey split per image, so the samples differ on the same seed."""
    from bagel_tpu_torch.models.bagel import patchify_latent
    from bagel_tpu_torch.models.vae import vae_encode

    batch = host.batch.to(device)
    if not host.vae_images:
        return batch
    parts = []
    with torch.no_grad():
        for img in host.vae_images:
            x = torch.as_tensor(np.asarray(img, np.float32), device=device)[None]
            z = vae_encode(vae_params, cfg.vae, x, generator=generator)[0]
            parts.append(patchify_latent(z, cfg.latent_patch_size))
    packed = torch.cat(parts, 0)
    vae_patches = batch.vae_patches.clone()
    vae_patches[: packed.shape[0]] = packed.to(vae_patches.dtype)
    return dataclasses.replace(batch, vae_patches=vae_patches)


# ---------------------------------------------------------------------------
# Packing loop over grouped dataset iterators (dataset_base.py:238-304)
# ---------------------------------------------------------------------------


class PackedBatchIterator:
    def __init__(
        self,
        packer_cfg: PackerConfig,
        grouped_iterators: Sequence,
        weights: Sequence[float],
        is_mandatory: Sequence[bool],
        special_tokens: dict,
        expected_num_tokens: int = 32768,
        max_num_tokens_per_sample: int = 16384,
        max_num_tokens: int = 36864,
        prefer_buffer_before: int = 16384,
        max_buffer_size: int = 50,
        seed: int = 0,
        finalize_kwargs: Optional[dict] = None,
    ):
        self.cfg = packer_cfg
        self.iters = list(grouped_iterators)
        self.weights = list(weights)
        self.is_mandatory = list(is_mandatory)
        self.special_tokens = special_tokens
        self.expected_num_tokens = expected_num_tokens
        self.max_num_tokens_per_sample = max_num_tokens_per_sample
        self.max_num_tokens = max_num_tokens
        self.prefer_buffer_before = prefer_buffer_before
        self.max_buffer_size = max_buffer_size
        self.rng = pyrandom.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.finalize_kwargs = finalize_kwargs or {}

    def _new_builder(self) -> SequenceBuilder:
        return SequenceBuilder(
            self.cfg, self.special_tokens, rng=self.rng, np_rng=self.np_rng
        )

    def _sample_len(self, sample) -> int:
        return sample["num_tokens"] + 2 * len(sample["sequence_plan"])

    def __iter__(self):
        total = sum(self.weights)
        assert total > 0
        cumprobs = [sum(self.weights[: i + 1]) / total for i in range(len(self.weights))]
        builder = self._new_builder()
        buffer: List[dict] = []

        while True:
            if builder.curr == 0:
                for gi, it in enumerate(self.iters):
                    if self.is_mandatory[gi]:
                        while True:
                            sample = next(it)
                            if self._sample_len(sample) < self.max_num_tokens_per_sample:
                                builder.pack_sample(sample)
                                break

            if builder.curr < self.prefer_buffer_before and buffer:
                sample = buffer.pop(0)
                from_buffer = True
            else:
                n = self.rng.random()
                gi = next(
                    (i for i, c in enumerate(cumprobs) if n < c),
                    len(cumprobs) - 1,
                )
                sample = next(self.iters[gi])
                from_buffer = False

            ntok = self._sample_len(sample)
            if ntok > self.max_num_tokens_per_sample:
                continue

            if builder.curr + ntok > self.max_num_tokens:
                if len(buffer) < self.max_buffer_size and not from_buffer:
                    buffer.append(sample)
                else:
                    yield finalize(builder, **self.finalize_kwargs)
                    builder = self._new_builder()
                continue

            builder.pack_sample(sample)
            if builder.curr >= self.expected_num_tokens:
                yield finalize(builder, **self.finalize_kwargs)
                builder = self._new_builder()


# ---------------------------------------------------------------------------
# Synthetic batches for tests / dryrun / bench
# ---------------------------------------------------------------------------


def make_synthetic_batch(
    cfg: BagelConfig,
    rng: np.random.Generator,
    seq_len: int = 256,
    n_text: int = 32,
    vit_hw: tuple = (28, 28),
    vae_hw: tuple = (32, 32),
) -> PackedTrainBatch:
    """One packed sample: [causal text | full vit image | noise vae image]
    with pre-filled random latents (no VAE encode), as CPU tensors."""
    p_vit = cfg.vit.patch_size
    n_vit = (vit_hw[0] // p_vit) * (vit_hw[1] // p_vit)
    down = cfg.latent_downsample
    h, w = vae_hw[0] // down, vae_hw[1] // down
    n_vae = h * w
    total = n_text + n_vit + n_vae
    assert total <= seq_len - 1, f"{total} tokens > seq_len-1 {seq_len - 1}"

    text_ids = rng.integers(0, cfg.llm.vocab_size, n_text).astype(np.int32)
    text_idx = np.arange(n_text, dtype=np.int32)
    vit_idx = np.arange(n_text, n_text + n_vit, dtype=np.int32)
    vae_idx = np.arange(n_text + n_vit, total, dtype=np.int32)

    vit_patches = rng.standard_normal((n_vit, cfg.vit.patch_dim)).astype(np.float32)
    vit_pos = np.asarray(
        flattened_position_ids_extrapolate(
            vit_hw[0], vit_hw[1], p_vit, cfg.vit_max_num_patch_per_side
        )
    )
    vae_patches = rng.standard_normal((n_vae, cfg.patch_latent_dim)).astype(np.float32)
    vae_pos = np.asarray(
        flattened_position_ids_extrapolate(
            vae_hw[0], vae_hw[1], down, cfg.max_latent_size
        )
    )

    position_ids = np.zeros(seq_len, np.int32)
    position_ids[text_idx] = np.arange(n_text)
    position_ids[vit_idx] = n_text
    position_ids[vae_idx] = n_text + 1

    document_id = np.zeros(seq_len, np.int32)
    document_id[:total] = 1
    fan_id = np.full(seq_len, -1, np.int32)
    fan_id[vit_idx] = 1
    fan_id[vae_idx] = 2
    noise_id = np.full(seq_len, -1, np.int32)
    noise_id[vae_idx] = 2
    gen_mask = np.zeros(seq_len, bool)
    gen_mask[vae_idx] = True

    ce_idx = text_idx[:-1]
    ce_labels = text_ids[1:]
    ce_weight = np.ones(n_text - 1, np.float32)
    raw_t = rng.standard_normal(()).astype(np.float32)

    t = torch.as_tensor
    return PackedTrainBatch(
        text_ids=t(text_ids),
        text_idx=t(text_idx),
        vit_patches=t(vit_patches),
        vit_pos_ids=t(vit_pos),
        vit_seg_ids=torch.ones(n_vit, dtype=torch.int32),
        vit_idx=t(vit_idx),
        vae_patches=t(vae_patches),
        vae_pos_ids=t(vae_pos),
        vae_idx=t(vae_idx),
        vae_timesteps=torch.full((n_vae,), float(raw_t)),
        position_ids=t(position_ids),
        document_id=t(document_id),
        fan_id=t(fan_id),
        noise_id=t(noise_id),
        gen_mask=t(gen_mask),
        ce_idx=t(ce_idx),
        ce_labels=t(ce_labels),
        ce_weight=t(ce_weight),
        mse_weight=torch.ones(n_vae, dtype=torch.float32),
    )


# index fields scatter into the packed sequence; their pad entries must point
# at a harmless sink slot inside *their own* sequence (weights are 0 there)
_IDX_FIELDS = {"text_idx", "vit_idx", "vae_idx", "ce_idx"}
_FILL = {"vae_timesteps": NEG_INF, "fan_id": -1, "noise_id": -1}


def stack_batches(batches) -> PackedTrainBatch:
    """Stack per-sequence batches into one leading batch axis.

    Batches coming out of `finalize` can land in different static buckets
    (content-dependent seq/text/vit/vae sizes); each field is padded up to
    the group max before stacking so dp-many sequences form one [B, ...]
    batch. Pad semantics: grown sequence tail keeps padding markers (doc 0,
    fan/noise -1, timestep -inf); grown index buckets keep pointing at the
    original sink slot (s_own - 1), which stays a padding slot after growth
    because real tokens occupy a prefix — and every loss weight there is 0.
    """
    batches = [b.map(torch.as_tensor) for b in batches]
    if len(batches) == 1:
        return batches[0].map(lambda x: x[None])

    out = {}
    for f in dataclasses.fields(PackedTrainBatch):
        vals = [getattr(b, f.name) for b in batches]
        n = max(v.shape[0] for v in vals)
        padded = []
        for b, v in zip(batches, vals):
            if v.shape[0] == n:
                padded.append(v)
                continue
            if f.name in _IDX_FIELDS:
                fill = b.position_ids.shape[0] - 1  # this sequence's sink
            else:
                fill = _FILL.get(f.name, 0)
            pad = torch.full((n - v.shape[0],) + tuple(v.shape[1:]), fill, dtype=v.dtype,
                             device=v.device)
            padded.append(torch.cat([v, pad], 0))
        out[f.name] = torch.stack(padded, 0)
    return PackedTrainBatch(**out)
