"""Dataset iterators: rank/worker-sharded streaming over parquet and jsonl
(port of bagel_tpu/data/datasets.py).

Mirrors the reference dataset family (data/t2i_dataset.py, vlm_dataset.py,
interleave_datasets/*, distributed_iterable_dataset.py, dataset_info.py) but
framework-free: plain Python iterators that a prefetching loader can fan out
(no torch DataLoader). Every sample carries `data_indexes` so the trainer
can checkpoint exact stream positions per dataset/worker (SURVEY §5.3).

Sample contract (consumed by packing.SequenceBuilder.pack_sample):
  dict(image_tensor_list=[HWC float arrays], text_ids_list=[[int]],
       sequence_plan=[{type, enable_cfg, loss, special_token_loss,
                       special_token_label, (split_start/split_end,
                       frame_delta)}],
       num_tokens=int, data_indexes={...})
"""

from __future__ import annotations

import io
import json
import os
import random
import traceback
from typing import Dict, Optional, Sequence

from bagel_tpu_torch.data.transforms import ImageTransform, pil_img2rgb


def _open_image(fp):
    """PIL.Image.open with the reference's decoder limits; PIL (like
    pyarrow) is imported where a sample is read, not with the package."""
    from PIL import Image, ImageFile, PngImagePlugin

    Image.MAX_IMAGE_PIXELS = 200_000_000
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    PngImagePlugin.MAX_TEXT_CHUNK = 1024 * 2**20
    return Image.open(fp)


def _decode_rows_batched(rows, transform: ImageTransform, window: int = 8):
    """Decode a stream of (meta, image_bytes) into (meta, HWC float array)
    through the native threaded decode+resize pool (native/imagepool.cc) in
    look-ahead windows; PIL fallback per image. Rows that fail to decode are
    dropped — the reference's try/except-continue (t2i_dataset.py:45-49).
    """
    from bagel_tpu_torch.native.imagepool import JpegBatchTransform

    batch_tf = JpegBatchTransform(transform)
    pending: list = []

    def flush():
        outs = batch_tf([b for _, b in pending])
        for (meta, _), arr in zip(pending, outs):
            if arr is not None:
                yield meta, arr
        pending.clear()

    for item in rows:
        pending.append(item)
        if len(pending) >= window:
            yield from flush()
    if pending:
        yield from flush()


def list_parquet_files(data_dir_list: Sequence[str], num_used: Sequence[int]):
    """Deterministic parquet discovery (parquet_utils.py:15-56). Local and
    `hdfs://` directories both work (data/filesystem.py); local listings are
    identical on every host, HDFS multi-host discovery can use
    filesystem.get_parquet_data_paths for rank-sharded listing."""
    from bagel_tpu_torch.data.filesystem import list_dir

    paths = []
    for d, n in zip(data_dir_list, num_used):
        files = sorted(f for f in list_dir(d) if f.endswith(".parquet"))
        if n and n > 0:
            if n < len(files):
                files = files[:n]
            else:  # repeat to reach the requested count
                files = (files * (-(-n // len(files))))[:n]
        paths.extend(files)
    return paths


class DistributedIterable:
    """Rank+worker file sharding with deterministic shuffle
    (distributed_iterable_dataset.py:8-58)."""

    def __init__(self, dataset_name: str, local_rank: int = 0,
                 world_size: int = 1, num_workers: int = 1, worker_id: int = 0):
        self.dataset_name = dataset_name
        self.local_rank = local_rank
        self.world_size = world_size
        self.num_workers = max(1, num_workers)
        self.worker_id = worker_id
        self.rng = random.Random()
        self.data_paths = None

    def set_epoch(self, seed: int = 42):
        if self.data_paths is None:
            return
        if isinstance(self.data_paths[0], tuple):
            paths = sorted(self.data_paths, key=lambda x: (x[0], x[1]))
        else:
            paths = sorted(self.data_paths)
        self.rng.seed(seed)
        self.rng.shuffle(paths)
        per_rank = max(1, len(paths) // self.world_size)
        start = self.local_rank * per_rank
        self.data_paths_per_rank = paths[start : start + per_rank]
        self.num_files_per_rank = per_rank

    def get_data_paths_per_worker(self):
        if self.num_workers <= 1:
            return self.data_paths_per_rank, 0
        per_worker = max(1, self.num_files_per_rank // self.num_workers)
        start = per_worker * self.worker_id
        return (
            self.data_paths_per_rank[start : start + per_worker][::-1],
            self.worker_id,
        )


class T2IIterableDataset(DistributedIterable):
    """Parquet rows {image: bytes, captions: json dict} -> plan
    [text(cfg-dropout-able), vae_image(loss)] (t2i_dataset.py:17-128)."""

    def __init__(self, dataset_name, transform: ImageTransform, tokenizer,
                 data_dir_list, num_used_data=None, local_rank=0,
                 world_size=1, num_workers=1, worker_id=0, data_status=None):
        super().__init__(dataset_name, local_rank, world_size, num_workers, worker_id)
        self.transform = transform
        self.tokenizer = tokenizer
        self.data_status = data_status
        self.data_paths = list_parquet_files(
            data_dir_list, num_used_data or [0] * len(data_dir_list)
        )
        self.set_epoch()

    def __iter__(self):
        from bagel_tpu_torch.data.filesystem import open_parquet

        paths, worker_id = self.get_data_paths_per_worker()
        if self.data_status is not None and worker_id in self.data_status:
            pq_start, rg_start, row_start = self.data_status[worker_id]
            row_start += 1
        else:
            pq_start = rg_start = row_start = 0
        stride = self.transform.stride

        while True:
            for pq_idx, path in enumerate(paths[pq_start:], start=pq_start):
                fr = open_parquet(path)
                for rg in range(rg_start, fr.num_row_groups):
                    df = fr.read_row_group(rg).to_pandas().iloc[row_start:]

                    def rows():
                        for row_idx, row in df.iterrows():
                            try:
                                captions = json.loads(row["captions"])
                            except Exception:
                                continue
                            yield (row_idx, captions), row["image"]

                    for (row_idx, captions), image_arr in _decode_rows_batched(
                        rows(), self.transform
                    ):
                        h, w = image_arr.shape[:2]
                        num_tokens = w * h // stride**2
                        caps = [self.tokenizer.encode(v) for v in captions.values()]
                        text_ids = (
                            random.choice(caps) if caps
                            else self.tokenizer.encode(" ")
                        )
                        num_tokens += len(text_ids)
                        yield dict(
                            image_tensor_list=[image_arr],
                            text_ids_list=[text_ids],
                            num_tokens=num_tokens,
                            sequence_plan=[
                                dict(type="text", enable_cfg=1, loss=0,
                                     special_token_loss=0, special_token_label=None),
                                dict(type="vae_image", enable_cfg=0, loss=1,
                                     special_token_loss=0, special_token_label=None),
                            ],
                            data_indexes=dict(
                                data_indexes=[pq_idx, rg, row_idx],
                                worker_id=worker_id,
                                dataset_name=self.dataset_name,
                            ),
                        )
                    row_start = 0
                rg_start = 0
            pq_start = 0


class SftJSONLIterableDataset(DistributedIterable):
    """LLaVA-style conversations: '<image>' -> vit_image, gpt turns get CE
    loss (vlm_dataset.py:20-195). A video sample takes `frame_sampler`'s
    frames (data/video.py FrameSampler), one '<image>' each in place of
    '<video>'."""

    def __init__(self, dataset_name, transform: ImageTransform, tokenizer,
                 jsonl_path_list, data_dir_list, num_used_data=None,
                 local_rank=0, world_size=1, num_workers=1, worker_id=0,
                 data_status=None, shuffle_lines=False, shuffle_seed=0,
                 frame_sampler=None):
        super().__init__(dataset_name, local_rank, world_size, num_workers, worker_id)
        self.transform = transform
        self.tokenizer = tokenizer
        self.frame_sampler = frame_sampler
        self.data_status = data_status
        rows = []
        num_used_data = num_used_data or [0] * len(jsonl_path_list)
        for jsonl_path, image_dir, n in zip(jsonl_path_list, data_dir_list, num_used_data):
            with open(jsonl_path) as f:
                lines = f.readlines()
            if shuffle_lines:
                self.rng.seed(shuffle_seed)
                self.rng.shuffle(lines)
            if n and n > 0:
                lines = lines[:n]
            rows.extend((line, image_dir) for line in lines)
        self.data_paths = rows
        self.set_epoch()

    def _elements(self, data, num_images):
        """Flatten a LLaVA-style conversation into a typed element stream.

        Assistant ('gpt') turns carry CE loss verbatim. Human turns may
        embed `<image>` placeholders: each boundary k becomes an image slot
        as long as k stays under the sample's image budget, and the text
        between boundaries is emitted stripped (turns without a placeholder
        pass through unstripped). Semantics match the reference's
        change_format (vlm_dataset.py:68-95)."""
        def human_turn(text):
            segments = text.split("<image>")
            if len(segments) == 1:
                yield dict(type="text", has_loss=0, text=text)
                return
            for k, seg in enumerate(segments):
                if seg.strip():
                    yield dict(type="text", has_loss=0, text=seg.strip())
                if k < len(segments) - 1 and k < num_images:
                    yield dict(type="image")

        out = []
        for turn in data["conversations"]:
            if turn["from"] == "human":
                out.extend(human_turn(turn["value"]))
            elif turn["from"] == "gpt":
                out.append(dict(type="text", has_loss=1, text=turn["value"]))
        return out

    def __iter__(self):
        rows, worker_id = self.get_data_paths_per_worker()
        row_start = 0
        if self.data_status is not None and worker_id in self.data_status:
            row_start = self.data_status[worker_id] + 1
        stride = self.transform.stride

        while True:
            for row_idx, (line, image_dir) in enumerate(rows[row_start:], start=row_start):
                try:
                    data = json.loads(line)
                    raw_images = []
                    if "image" in data:
                        names = data["image"]
                        names = names if isinstance(names, list) else [names]
                        raw_images = [
                            pil_img2rgb(_open_image(os.path.join(image_dir, n)))
                            for n in names
                        ]
                    elif "video" in data:
                        if self.frame_sampler is None:
                            raise RuntimeError("video sample but no frame_sampler")
                        raw_images = self.frame_sampler(
                            os.path.join(image_dir, data["video"])
                        )
                        tags = "<image>" * len(raw_images)
                        for conv in data["conversations"]:
                            if "<video>" in conv["value"]:
                                conv["value"] = conv["value"].replace("<video>", tags)
                                break
                except Exception:
                    traceback.print_exc()
                    continue

                image_list, text_list, plan, num_tokens = [], [], [], 0
                for img in raw_images:
                    arr = self.transform(img, img_num=len(raw_images))
                    image_list.append(arr)
                    num_tokens += arr.shape[0] * arr.shape[1] // stride**2

                for el in self._elements(data, len(image_list)):
                    if el["type"] == "text":
                        ids = self.tokenizer.encode(el["text"])
                        if ids:
                            text_list.append(ids)
                            num_tokens += len(ids)
                            plan.append(dict(
                                type="text", enable_cfg=0, loss=el["has_loss"],
                                special_token_loss=0, special_token_label=None,
                            ))
                    else:
                        plan.append(dict(
                            type="vit_image", enable_cfg=0, loss=0,
                            special_token_loss=0, special_token_label=None,
                        ))

                if not any(p["loss"] for p in plan):
                    continue
                yield dict(
                    image_tensor_list=image_list,
                    text_ids_list=text_list,
                    sequence_plan=plan,
                    num_tokens=num_tokens,
                    data_indexes=dict(
                        data_indexes=row_idx, worker_id=worker_id,
                        dataset_name=self.dataset_name,
                    ),
                )
            row_start = 0


class InterleavedBase(DistributedIterable):
    """Plan builders shared by interleaved datasets
    (interleave_t2i_dataset.py:10-131)."""

    transform: ImageTransform
    vit_transform: ImageTransform
    tokenizer = None

    def _init_data(self):
        return dict(sequence_plan=[], text_ids_list=[], image_tensor_list=[],
                    num_tokens=0)

    def _add_text(self, data, text, need_loss, enable_cfg=True):
        ids = self.tokenizer.encode(text)
        data["num_tokens"] += len(ids)
        data["text_ids_list"].append(ids)
        data["sequence_plan"].append(dict(
            type="text", enable_cfg=int(enable_cfg), loss=int(need_loss),
            special_token_loss=0, special_token_label=None,
        ))
        return data

    def _add_image(self, data, image, need_loss, need_vae, need_vit,
                   enable_cfg=True):
        assert need_loss or need_vae or need_vit
        if need_loss:
            arr = self.transform(image)
            data["sequence_plan"].append(dict(
                type="vae_image", enable_cfg=0, loss=1,
                special_token_loss=0, special_token_label=None,
            ))
            data["num_tokens"] += arr.shape[0] * arr.shape[1] // self.transform.stride**2
            data["image_tensor_list"].append(arr)
        if need_vae:
            arr = self.transform(image)
            data["sequence_plan"].append(dict(
                type="vae_image", enable_cfg=int(enable_cfg), loss=0,
                special_token_loss=0, special_token_label=None,
            ))
            data["num_tokens"] += arr.shape[0] * arr.shape[1] // self.transform.stride**2
            data["image_tensor_list"].append(arr.copy())
        if need_vit:
            arr = self.vit_transform(image)
            data["sequence_plan"].append(dict(
                type="vit_image", enable_cfg=int(enable_cfg), loss=0,
                special_token_loss=0, special_token_label=None,
            ))
            data["num_tokens"] += arr.shape[0] * arr.shape[1] // self.vit_transform.stride**2
            data["image_tensor_list"].append(arr)
        return data

    def _add_video(self, data, frames, frame_indexes, need_loss, need_vae,
                   enable_cfg=True):
        assert int(need_loss) + int(need_vae) == 1
        loss = 1 if need_loss else 0
        for idx, (image, frame_idx) in enumerate(zip(frames, frame_indexes)):
            plan = dict(
                type="vae_image",
                enable_cfg=0 if need_loss else int(enable_cfg),
                loss=loss, special_token_loss=0, special_token_label=None,
                split_start=idx == 0, split_end=idx == len(frames) - 1,
            )
            if idx < len(frame_indexes) - 1:
                plan["frame_delta"] = frame_indexes[idx + 1] - frame_idx
            data["sequence_plan"].append(plan)
            arr = self.transform(image)
            data["image_tensor_list"].append(arr)
            data["num_tokens"] += arr.shape[0] * arr.shape[1] // self.transform.stride**2
        return data


class ParquetStandardIterableDataset(DistributedIterable):
    """Row-group-sharded parquet iterator; subclasses implement parse_row
    (interleave_t2i_dataset.py:134-212)."""

    def __init__(self, dataset_name, transform, tokenizer, vit_transform,
                 data_dir_list, num_used_data=None, parquet_info=None,
                 local_rank=0, world_size=1, num_workers=1, worker_id=0,
                 data_status=None):
        DistributedIterable.__init__(
            self, dataset_name, local_rank, world_size, num_workers, worker_id
        )
        self.transform = transform
        self.vit_transform = vit_transform
        self.tokenizer = tokenizer
        self.data_status = data_status
        self.data_paths = self._row_groups(
            data_dir_list, num_used_data or [0] * len(data_dir_list),
            parquet_info,
        )
        self.set_epoch()

    def _row_groups(self, data_dir_list, num_used_data, parquet_info):
        from bagel_tpu_torch.data.filesystem import open_parquet

        row_groups = []
        for path in list_parquet_files(data_dir_list, num_used_data):
            if parquet_info and path in parquet_info:
                n = parquet_info[path]["num_row_groups"]
            else:
                n = open_parquet(path).num_row_groups
            row_groups.extend((path, i) for i in range(n))
        return row_groups

    def parse_row(self, row) -> dict:
        raise NotImplementedError

    def __iter__(self):
        from bagel_tpu_torch.data.filesystem import open_parquet

        groups, worker_id = self.get_data_paths_per_worker()
        g_start = row_start = 0
        if self.data_status is not None and worker_id in self.data_status:
            g_start, row_start = self.data_status[worker_id]
            row_start += 1

        while True:
            for g_idx, (path, rg) in enumerate(groups[g_start:], start=g_start):
                try:
                    df = open_parquet(path).read_row_group(rg).to_pandas()
                    df = df.iloc[row_start:]
                except Exception:
                    continue
                for row_idx, row in df.iterrows():
                    try:
                        data = self.parse_row(row)
                        if not data:
                            continue
                        data["data_indexes"] = dict(
                            data_indexes=[g_idx, row_idx],
                            worker_id=worker_id,
                            dataset_name=self.dataset_name,
                        )
                    except Exception:
                        continue
                    yield data
                row_start = 0
            g_start = 0


class UnifiedEditIterableDataset(InterleavedBase, ParquetStandardIterableDataset):
    """Multi-turn edit chains: source image gets VAE+ViT context tokens,
    targets get noised-VAE loss tokens (edit_dataset.py:19-72)."""

    def parse_row(self, row):
        """One training sample from a multi-turn edit chain.

        Distribution-defining decision procedure (matches the reference's
        edit_dataset.py:21-73 exactly, including the global-RNG draw order,
        so seeded plans are byte-identical — see
        tests/test_data_pipeline.py plan-parity test):

        1. pick a window of 1-2 hops: uniform start frame, then uniform end
           within two frames after it;
        2. on multi-hop windows, flip a coin to FUSE: join the hop
           instructions into one sentence and supervise only the window's
           final frame (stepping the end back if it is the chain's last
           frame) — context stays just the source image;
        3. otherwise walk hop by hop: every intermediate target is both
           supervised and re-encoded (VAE+ViT) as context for the next hop;
           the final target is supervision only.
        """
        frames = row["image_list"]
        hops = row["instruction_list"]  # hops[i] edits frame i -> i+1
        n = len(frames)
        start = random.choice(range(n - 1))
        end = random.choice(range(start + 1, min(start + 3, n)))

        def frame(i):
            return pil_img2rgb(_open_image(io.BytesIO(frames[i])))

        def hop_text(i):
            return random.choice(hops[i - 1])  # instruction into frame i

        data = self._add_image(
            self._init_data(), frame(start),
            need_loss=False, need_vae=True, need_vit=True,
        )

        fuse = end - start > 1 and random.random() < 0.5
        if fuse:
            if end == n - 1:
                end -= 1
            sentence = ". ".join(hop_text(i) for i in range(start + 1, end + 1))
            data = self._add_text(data, sentence + ".", need_loss=False)
            data = self._add_image(
                data, frame(end), need_loss=True, need_vae=False,
                need_vit=False,
            )
            return data

        for i in range(start + 1, end + 1):
            data = self._add_text(data, hop_text(i), need_loss=False)
            intermediate = i < end
            data = self._add_image(
                data, frame(i), need_loss=True,
                need_vae=intermediate, need_vit=intermediate,
            )
        return data


DATASET_REGISTRY: Dict[str, type] = {
    "t2i_pretrain": T2IIterableDataset,
    "vlm_sft": SftJSONLIterableDataset,
    "unified_edit": UnifiedEditIterableDataset,
}

# name -> per-dataset path metadata; users register their corpora here
# (dataset_info.py:9-39 equivalent)
DATASET_INFO: Dict[str, Dict[str, dict]] = {}


def register_dataset_info(group: str, name: str, **meta):
    DATASET_INFO.setdefault(group, {})[name] = meta


def build_grouped_datasets(
    grouped_config: dict,
    tokenizer,
    local_rank: int = 0,
    world_size: int = 1,
    num_workers: int = 1,
    worker_id: int = 0,
    data_status: Optional[dict] = None,
):
    """YAML group config -> (datasets, is_mandatory, weights)
    (dataset_base.py:91-155)."""
    datasets, is_mandatory, weights = [], [], []
    for group_name, args in grouped_config.items():
        args = dict(args)
        is_mandatory.append(args.pop("is_mandatory", False))
        weights.append(args.pop("weight", 0.0))

        if "image_transform_args" in args:
            args["transform"] = ImageTransform(**args.pop("image_transform_args"))
        if "vit_image_transform_args" in args:
            args["vit_transform"] = ImageTransform(
                **args.pop("vit_image_transform_args")
            )

        names = args.pop("dataset_names")
        args["data_dir_list"] = []
        for item in names:
            meta = DATASET_INFO[group_name][item]
            args["data_dir_list"].append(meta["data_dir"])
            if "parquet_info_path" in meta:
                with open(meta["parquet_info_path"]) as f:
                    args.setdefault("parquet_info", {}).update(json.load(f))
            if "jsonl_path" in meta:
                args.setdefault("jsonl_path_list", []).append(meta["jsonl_path"])

        resume = args.pop("resume_data_status", True)
        status = (
            data_status.get(group_name)
            if (data_status is not None and resume) else None
        )
        ds = DATASET_REGISTRY[group_name](
            dataset_name=group_name,
            tokenizer=tokenizer,
            local_rank=local_rank,
            world_size=world_size,
            num_workers=num_workers,
            worker_id=worker_id,
            data_status=status,
            **args,
        )
        datasets.append(ds)
    return datasets, is_mandatory, weights
