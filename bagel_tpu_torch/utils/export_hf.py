"""Export a parameter tree to upstream's release layout (port of
bagel_tpu/utils/export_hf.py; standard library around
`utils.convert.save_checkpoint_dir`).

The exported directory (model/ema/ae.safetensors, plus the tokenizer and
config sidecars copied from `tokenizer_src`) loads with upstream's app and
with `serving/app.py --checkpoint`. The JAX package's command line restores
its training state from an Orbax checkpoint first; the port has no training
checkpoints yet (ROADMAP A7), so it exports a tree it is given.
"""

from __future__ import annotations

import json
import os
import shutil

SIDECARS = (
    "llm_config.json", "vit_config.json", "config.json",
    "tokenizer.json", "tokenizer_config.json", "vocab.json",
    "merges.txt", "special_tokens_map.json", "generation_config.json",
)


def export_checkpoint(params: dict, cfg, out: str, tokenizer_src: str = "",
                      source: str = "") -> str:
    """Write `params` (the port's tree) to `out` in the release layout, copy
    the sidecars found under `tokenizer_src`, and record where the weights
    came from (`source`) in export_meta.json. Returns `out`."""
    from bagel_tpu_torch.utils.convert import save_checkpoint_dir

    save_checkpoint_dir(params, cfg, out)
    if tokenizer_src:
        for name in SIDECARS:
            src = os.path.join(tokenizer_src, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out, name))
    with open(os.path.join(out, "export_meta.json"), "w") as f:
        json.dump({"source": source}, f)
    return out
