"""Checkpoint save/restore and exact data-stream resume (port of
bagel_tpu/train/checkpoint.py).

Layout: <dir>/<step:07d>/{state/, data_status.json, config.json}, as in the
JAX package, but `state/` holds safetensors files (params, ema, the Adam
moments mu and nu, each leaf under its '/'-joined path) and `state.json`
(step, update count, which trees exist) in place of Orbax's format. A JAX
Orbax checkpoint is not read (ROADMAP A, reading a JAX Orbax training
state).

A save writes the files into `state.tmp-*`, renamed to `state` when
complete: with block=False it first copies the whole state to host memory
and writes on a background thread; with block=True it copies and writes
one tree at a time. `get_latest_ckpt` ignores a step directory without
`state`, so an unfinished save is never resumed from. The per-dataset and
per-worker stream positions (`data_status`) ride along as JSON; restoring
them reproduces the reference's exact resume (every sample carries
data_indexes, the trainer keeps the latest per dataset and worker, the
iterators fast-forward on restart).
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
from typing import Any, Optional, Tuple

import torch

from bagel_tpu_torch.configs import BagelConfig, config_to_json
from bagel_tpu_torch.train.step import TrainState, tree_map

_TREES = ("params", "ema", "mu", "nu")
_saver: Optional[threading.Thread] = None
_save_error: list = []


def wait_for_saves():
    """Block until the in-flight async save has finished writing (re-raising
    its error, if any). Call before reading a just-written checkpoint and
    at trainer exit."""
    global _saver
    if _saver is not None:
        _saver.join()
        _saver = None
    if _save_error:
        raise _save_error.pop()


def _flatten(tree, prefix="") -> dict:
    """{'/'-joined path: tensor} over dicts and lists; None leaves dropped."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {} if tree is None else {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _host_copy(tree) -> dict:
    return {k: v.detach().to("cpu", copy=True).contiguous() for k, v in _flatten(tree).items()}


def _trees(state: TrainState) -> dict:
    return {"params": state.params, "ema": state.ema_params,
            "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    state: TrainState,
    data_status: Optional[dict] = None,
    cfg: Optional[BagelConfig] = None,
    block: bool = True,
) -> str:
    """Save one checkpoint. block=False returns once the state is copied to
    host memory and writes the files on a background thread; call
    `wait_for_saves()` (or save with block=True) before depending on them."""
    from safetensors.torch import save_file

    path = os.path.join(os.path.abspath(ckpt_dir), f"{step:07d}")
    wait_for_saves()  # one save at a time
    if os.path.isdir(os.path.join(path, "state")):
        # already committed for this step (e.g. the final save of a resumed
        # run that had nothing left to do); the driver refuses the layout
        # where a fresh run would collide with old steps
        logging.getLogger("bagel_tpu_torch").warning(
            "checkpoint step %d already committed in %s: skipping save "
            "(the existing state is kept)", step, ckpt_dir)
        return path
    trees = {name: tree for name, tree in _trees(state).items() if tree is not None}
    # async: the whole state is copied to host memory before the loop goes
    # on; blocking: one tree at a time, so host memory holds one tree
    host = {name: _host_copy(tree) for name, tree in trees.items()} if not block else None
    meta = {"step": state.step, "count": state.opt_state["count"], "trees": sorted(trees)}
    rank0 = _rank() == 0

    def write():
        try:
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, f"state.tmp-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for name in trees:
                tensors = host.pop(name) if host is not None else _host_copy(trees[name])
                save_file(tensors, os.path.join(tmp, f"{name}.safetensors"))
                del tensors
            with open(os.path.join(tmp, "state.json"), "w") as f:
                json.dump(meta, f)
            if rank0:
                if data_status is not None:
                    with open(os.path.join(path, "data_status.json"), "w") as f:
                        json.dump(_jsonify(data_status), f)
                if cfg is not None:
                    with open(os.path.join(path, "config.json"), "w") as f:
                        f.write(config_to_json(cfg))
            os.replace(tmp, os.path.join(path, "state"))  # commit
        except BaseException as e:  # surfaced by wait_for_saves
            _save_error.append(e)

    if block:
        write()
        wait_for_saves()
    else:
        global _saver
        _saver = threading.Thread(target=write, daemon=True)
        _saver.start()
    return path


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _load(state_dir: str, name: str) -> dict:
    from safetensors.torch import load_file

    return load_file(os.path.join(state_dir, f"{name}.safetensors"))


def _fill(tree, loaded: dict, prefix="", skip=()):
    """Copy loaded tensors into tree's leaves in place (device and pinning
    kept); top-level groups in `skip` are left as they are."""
    for path, t in _flatten(tree, prefix).items():
        if path.split("/")[0] in skip:
            continue
        if path not in loaded:
            raise KeyError(f"checkpoint has no leaf {path}")
        src = loaded[path]
        if src.shape != t.shape:
            raise ValueError(f"{path}: checkpoint shape {tuple(src.shape)}, model {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(src)


def restore_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, Optional[dict]]:
    """Restore a full training state into `state` in place (each leaf keeps
    its device): parameters, EMA, moments, update count and step. Returns
    (state, data_status)."""
    state_dir = os.path.join(path, "state")
    meta = checkpoint_meta(path)
    for name, tree in _trees(state).items():
        if tree is None:
            continue
        if name not in meta["trees"]:
            raise ValueError(f"checkpoint {path} has no {name} tree")
        _fill(tree, _load(state_dir, name))
    state.step = meta["step"]
    state.opt_state["count"] = meta["count"]
    ds_path = os.path.join(path, "data_status.json")
    data_status = None
    if os.path.exists(ds_path):
        with open(ds_path) as f:
            data_status = _dejsonify(json.load(f))
    return state, data_status


# Regenerated-from-config sin-cos tables: never restored, so a checkpoint
# saved at another max_latent_size / vit grid still loads (the reference
# pops these keys before load_state_dict, fsdp_utils.py:161-164,177-178).
_POS_BUFFERS = ("vit_pos_embed", "latent_pos_embed")


def restore_params_only(
    path: str, current_params: dict, from_ema: bool = False
) -> Tuple[dict, Optional[dict]]:
    """Model weights only (the reference's resume_model_only /
    finetune_from_ema, pretrain_unified_navit.py:449-466): moments, step
    and data_status start fresh.

    Returns (params, ema_params): new trees on current_params' devices;
    `params` holds the checkpoint's EMA weights when from_ema, else its raw
    weights; `ema_params` is the checkpoint's EMA tree when it has one,
    else None. The sin-cos tables, and groups the checkpoint lacks, keep
    current_params' values (the reference loads with strict=False)."""
    state_dir = os.path.join(path, "state")
    has_ema = "ema" in checkpoint_meta(path)["trees"]
    if from_ema and not has_ema:
        raise ValueError(f"--finetune_from_ema: checkpoint {path} was saved without EMA")

    def build(name):
        loaded = _load(state_dir, name)
        groups = {p.split("/")[0] for p in loaded}
        tree = tree_map(lambda t: t.detach().clone(), current_params)
        _fill(tree, loaded, skip=set(_POS_BUFFERS) | (set(current_params) - groups))
        return tree

    params = build("ema" if from_ema else "params")
    ema = build("ema") if has_ema else None
    return params, ema


def _unflatten(flat: dict):
    """Inverse of `_flatten`: a level whose keys are 0..n-1 becomes a list."""
    tree: dict = {}
    for path, t in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


def checkpoint_meta(path: str) -> dict:
    """A step directory's state.json: step, update count and saved trees."""
    with open(os.path.join(path, "state", "state.json")) as f:
        return json.load(f)


def load_tree(path: str, name: str) -> dict:
    """One saved tree of a step directory ('params', 'ema', 'mu' or 'nu')
    as it was saved, with no model to fill: nested dicts and lists of CPU
    tensors."""
    return _unflatten(_load(os.path.join(path, "state"), name))


def get_latest_ckpt(ckpt_dir: str) -> Optional[str]:
    """The step directory with the largest step whose `state` is committed."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [d for d in os.listdir(ckpt_dir)
             if re.fullmatch(r"\d+", d) and os.path.isdir(os.path.join(ckpt_dir, d, "state"))]
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps, key=int))


def step_from_path(path: str) -> int:
    return int(os.path.basename(os.path.normpath(path)))


def gather_data_status(data_status: dict) -> dict:
    """{process index: data_status} over the processes of the default
    torch.distributed group (one process: {0: data_status}), so the
    checkpoint records every process's stream positions (the reference
    gathers rank dicts, pretrain_unified_navit.py:789-808)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return {0: data_status}
    shards = [None] * dist.get_world_size()
    dist.all_gather_object(shards, _jsonify(data_status))
    return {r: _dejsonify(s) for r, s in enumerate(shards)}


def data_status_for_process(saved: Optional[dict], rank: int) -> dict:
    """This process's slice of a saved data_status: the gathered {rank:
    status} layout, or a single-process dict (dataset names as keys)."""
    if not saved:
        return {}
    if all(isinstance(k, int) for k in saved.keys()):
        return saved.get(rank, {})
    return saved if rank == 0 else {}


def update_data_status(data_status: dict, data_indexes_list) -> dict:
    """Fold a batch's data_indexes into the running per-dataset/worker
    positions (pretrain_unified_navit.py:789-794)."""
    for item in data_indexes_list:
        ds = data_status.setdefault(item["dataset_name"], {})
        ds[item["worker_id"]] = item["data_indexes"]
    return data_status


def _jsonify(obj: Any):
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    return obj


def _dejsonify(obj: Any):
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            key = int(k) if k.lstrip("-").isdigit() else k
            out[key] = _dejsonify(v)
        return out
    return obj
