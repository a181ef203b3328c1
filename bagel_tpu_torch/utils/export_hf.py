"""Export a training checkpoint, or a parameter tree, to upstream's release
layout (port of bagel_tpu/utils/export_hf.py).

Closes the training loop: train with `train/driver.py` (checkpoints under
<ckpt_dir>/<step>/state), then export to the model/ema/ae.safetensors
layout that upstream's app and `serving/app.py --checkpoint` load.

  python -m bagel_tpu_torch.utils.export_hf --ckpt results/ckpt --out hf_out \
      [--raw] [--tokenizer_src /path/BAGEL-7B-MoT]

--ckpt accepts a step directory (results/ckpt/0001000) or the checkpoint
root (the latest committed step is picked). EMA weights are exported when
the state carries them (upstream evaluates EMA); --raw exports the raw
training parameters instead. --tokenizer_src copies the tokenizer and
config sidecars, so the exported directory loads as a release checkpoint.
export_meta.json records the source step directory, which weights were
written ("ema" or "params") and the step. Export is host-side layout work:
it reads and writes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

SIDECARS = (
    "llm_config.json", "vit_config.json", "config.json",
    "tokenizer.json", "tokenizer_config.json", "vocab.json",
    "merges.txt", "special_tokens_map.json", "generation_config.json",
)


def export_checkpoint(params: dict, cfg, out: str, tokenizer_src: str = "",
                      source: str = "", **meta) -> str:
    """Write `params` (the port's tree) to `out` in the release layout, copy
    the sidecars found under `tokenizer_src`, and record where the weights
    came from (`source`, and any `meta` fields) in export_meta.json.
    Returns `out`."""
    from bagel_tpu_torch.utils.convert import save_checkpoint_dir

    save_checkpoint_dir(params, cfg, out)
    if tokenizer_src:
        for name in SIDECARS:
            src = os.path.join(tokenizer_src, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out, name))
    with open(os.path.join(out, "export_meta.json"), "w") as f:
        json.dump({"source": source, **meta}, f)
    return out


def export_from_checkpoint(ckpt: str, out: str, use_ema: bool = True,
                           tokenizer_src: str = "") -> str:
    """Export the EMA weights (raw ones with use_ema=False, or when the
    state has no EMA) of the training checkpoint `ckpt`: a step directory,
    or a root whose latest committed step is taken. Returns `out`."""
    from bagel_tpu_torch.configs import bagel_config_from_json
    from bagel_tpu_torch.train.checkpoint import checkpoint_meta, get_latest_ckpt, load_tree

    path = ckpt
    if not os.path.exists(os.path.join(path, "state")):
        latest = get_latest_ckpt(ckpt)
        if latest is None:
            raise FileNotFoundError(f"no step checkpoints under {ckpt}")
        path = latest
    with open(os.path.join(path, "config.json")) as f:
        cfg = bagel_config_from_json(f.read())
    meta = checkpoint_meta(path)
    weights = "ema" if use_ema and "ema" in meta["trees"] else "params"
    return export_checkpoint(load_tree(path, weights), cfg, out, tokenizer_src,
                             source=os.path.abspath(path), weights=weights,
                             step=int(meta.get("step", -1)))


def main(argv=None):
    ap = argparse.ArgumentParser("bagel_tpu_torch HF export")
    ap.add_argument("--ckpt", required=True,
                    help="step dir or checkpoint root (latest picked)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--raw", action="store_true",
                    help="export raw training params instead of EMA")
    ap.add_argument("--tokenizer_src", type=str, default="",
                    help="copy tokenizer/config sidecars from this dir")
    args = ap.parse_args(argv)
    out = export_from_checkpoint(args.ckpt, args.out, use_ema=not args.raw,
                                 tokenizer_src=args.tokenizer_src)
    print(f"exported to {out}")


if __name__ == "__main__":
    main()
