"""Convert a bagel_tpu training state (Orbax) into bagel_tpu_torch's
checkpoint format, so that the port resumes it, finetunes from its weights
or its EMA, or exports it.

  python tools/orbax_to_torch.py --ckpt <JAX ckpt_dir or step dir> --out <port ckpt_dir>

Run it where the JAX package runs: it needs JAX, Orbax (with tensorstore)
and PyTorch's CPU build, and no accelerator. `--ckpt` is a step directory
(<ckpt_dir>/<step>, holding `state/`) or a checkpoint root, whose newest
committed step is taken, as `bagel_tpu.train.checkpoint.get_latest_ckpt`
finds it. The result is `<out>/<step:07d>/`, as the port's
`save_checkpoint` writes it: `state/` with `params`, `ema` (where the state
has EMA), `mu` and `nu` (Adam's moments) as safetensors and `state.json`
(the TrainState's step, Adam's update count, the trees written), committed
by a rename; beside it `data_status.json` and `config.json`, copied as they
are (the two packages share both formats). An output step that is already
committed is refused.

The tree's structure comes from the checkpoint's own metadata, not from a
rebuilt optimizer: the frozen groups are not stored, and `optax.masked`
leaves their moments `None`. `opt_state` must hold exactly one Adam state
{count, mu, nu}; a schedule's {count} must agree with its count. Every
leaf goes through the port's own leaf map (`bagel_tpu_torch.utils.bridge.
port_layout`: the VAE's conv kernels, their EMA and moments HWIO -> OIHW)
and keeps its saved dtype.

Memory: the host holds one leaf at a time. Each Orbax read restores one
leaf as a numpy array (the saved shardings and memory kinds ignored), which
is written before the next read, so a full BAGEL-7B state (params, EMA and
fp32 moments) needs about twice its largest leaf (a stacked FFN weight,
28 x 3584 x 18944 fp32, 7.6 GB): the read array and its tensor. A state
saved by several processes or over a mesh reads as the same leaves.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a script from anywhere
    sys.path.insert(0, REPO)

ADAM = frozenset({"count", "mu", "nu"})


def step_dir(ckpt: str) -> str:
    """`ckpt` if it holds `state/`, else its newest committed step."""
    from bagel_tpu.train.checkpoint import get_latest_ckpt

    if os.path.isdir(os.path.join(ckpt, "state")):
        return ckpt
    latest = get_latest_ckpt(ckpt)
    if latest is None:
        raise FileNotFoundError(f"no committed step checkpoint under {ckpt}")
    return latest


def _nodes(tree, path=()):
    """(path, node) of every dict, list and tuple in a metadata tree."""
    if isinstance(tree, dict):
        yield path, tree
        for k, v in tree.items():
            yield from _nodes(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        yield path, tree
        for i, v in enumerate(tree):
            yield from _nodes(v, path + (i,))


def adam_paths(opt_state) -> tuple:
    """(the path of the one Adam state {count, mu, nu} in an opt_state
    metadata tree, the paths of the schedule states {count}). Raises,
    naming what it found, unless there is exactly one Adam state."""
    adam, schedules = [], []
    for path, node in _nodes(opt_state):
        if isinstance(node, dict) and set(node) == ADAM:
            adam.append(path)
        elif isinstance(node, dict) and set(node) == {"count"}:
            schedules.append(path)
    if len(adam) != 1:
        found = sorted({tuple(sorted(node)) for _, node in _nodes(opt_state)
                        if isinstance(node, dict) and "count" in node})
        raise ValueError(
            f"opt_state must hold exactly one Adam state {{count, mu, nu}}, found "
            f"{len(adam)} (at {adam}); its nodes with a count: {found or 'none'}")
    return adam[0], schedules


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaves(tree, prefix=()):
    """(path, ArrayMetadata) of a metadata subtree in its order; None
    (a masked or absent node) holds none."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


class OrbaxReader:
    """One leaf of an Orbax state directory a call, as a numpy array on the
    host, through Orbax's own array deserialization (what its
    PyTreeCheckpointHandler runs for each leaf it restores, here without
    the whole tree's metadata read again for every leaf)."""

    def __init__(self, state_dir: str, use_zarr3: bool):
        import orbax.checkpoint as ocp
        from etils import epath
        from orbax.checkpoint import type_handlers

        self._info = dict(parent_dir=epath.Path(state_dir), is_ocdbt_checkpoint=True,
                          use_zarr3=use_zarr3,
                          ts_context=type_handlers.get_ts_context(use_ocdbt=True))
        self._param_info = type_handlers.ParamInfo
        self._handler = type_handlers.NumpyHandler()
        self._args = [ocp.RestoreArgs(restore_type=np.ndarray)]
        self._loop = asyncio.new_event_loop()

    def read(self, name: str) -> np.ndarray:
        """The leaf Orbax saved under the parameter name `name`."""
        info = self._param_info(name=name, **self._info)
        (arr,) = self._loop.run_until_complete(self._handler.deserialize([info], self._args))
        return arr

    def close(self) -> None:
        self._loop.close()


def convert(ckpt: str, out: str) -> str:
    """Convert the JAX step `ckpt` (a step directory or a root) into
    `<out>/<step:07d>`; returns that directory (module docstring)."""
    import orbax.checkpoint as ocp

    from bagel_tpu.train.checkpoint import step_from_path
    from bagel_tpu_torch.train.checkpoint import write_leaves
    from bagel_tpu_torch.utils.bridge import port_layout, port_leaf

    src = step_dir(ckpt)
    state_dir = os.path.join(os.path.abspath(src), "state")
    step = step_from_path(src)
    dst = os.path.join(os.path.abspath(out), f"{step:07d}")
    if os.path.isdir(os.path.join(dst, "state")):
        raise FileExistsError(f"step {step} is already committed in {out} ({dst}/state)")
    meta = ocp.StandardCheckpointer().metadata(state_dir).item_metadata
    tree = dict(meta.tree)
    names = ocp.tree.get_param_names(tree)
    adam, schedules = adam_paths(tree["opt_state"])
    adam_node = _at(tree["opt_state"], adam)
    trees = {"params": tree["params"], "ema": tree.get("ema_params"),
             "mu": adam_node["mu"], "nu": adam_node["nu"]}
    roots = {"params": ("params",), "ema": ("ema_params",), "mu": ("opt_state",) + adam + ("mu",),
             "nu": ("opt_state",) + adam + ("nu",)}
    reader = OrbaxReader(state_dir, meta.use_zarr3)
    tmp = os.path.join(dst, f"state.tmp-{os.getpid()}")
    try:
        count = int(reader.read(_at(names, ("opt_state",) + adam + ("count",))))
        for path in schedules:
            n = int(reader.read(_at(names, ("opt_state",) + path + ("count",))))
            if n != count:
                raise ValueError(f"the schedule state at opt_state{list(path)} counts {n}, "
                                 f"Adam's {count}")
        jstep = int(reader.read(names["step"]))
        os.makedirs(dst, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        written = []
        for name, sub in trees.items():
            if sub is None:  # a state saved without EMA
                continue
            leaves = list(_leaves(sub))
            specs = {}
            for path, m in leaves:  # the port's dtype and shape, from the metadata
                dtype = port_leaf(np.zeros((), m.dtype)).dtype
                spec = port_layout(torch.empty(m.shape, dtype=dtype, device="meta"))
                specs["/".join(map(str, path))] = (spec.dtype, tuple(spec.shape))
            orbax_names = [_at(names, roots[name] + path) for path, _ in leaves]
            write_leaves(os.path.join(tmp, f"{name}.safetensors"), specs,
                         ((k, port_leaf(reader.read(n))) for k, n in zip(specs, orbax_names)))
            written.append(name)
        with open(os.path.join(tmp, "state.json"), "w") as f:
            json.dump({"step": jstep, "count": count, "trees": sorted(written)}, f)
        for side in ("data_status.json", "config.json"):
            if os.path.exists(os.path.join(src, side)):
                shutil.copyfile(os.path.join(src, side), os.path.join(dst, side))
        os.replace(tmp, os.path.join(dst, "state"))  # commit
    finally:
        reader.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return dst


def main(argv=None) -> str:
    plat = os.environ.get("JAX_PLATFORMS")
    if plat:  # some TPU plugins ignore the variable; the conversion is host work
        import jax

        jax.config.update("jax_platforms", plat)
    ap = argparse.ArgumentParser("bagel_tpu (Orbax) -> bagel_tpu_torch checkpoint")
    ap.add_argument("--ckpt", required=True, help="JAX step dir or checkpoint root (newest taken)")
    ap.add_argument("--out", required=True, help="the port's checkpoint root")
    args = ap.parse_args(argv)
    dst = convert(args.ckpt, args.out)
    print(f"converted {step_dir(args.ckpt)} to {dst}")
    return dst


if __name__ == "__main__":
    main()
