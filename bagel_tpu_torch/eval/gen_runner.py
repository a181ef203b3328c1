"""Image-generation evaluation worker (port of bagel_tpu/eval/gen_runner.py).

The reference's eval/gen family (gen_images_mp*.py: torchrun rank-parallel
prompt sharding, fixed seed 42, skip-if-exists resumability; WISE variant
adds think-mode two-phase generation; imgedit/kris/rise/gedit variants add a
source image) collapses into one worker. Output uses the GenEval directory
layout (outdir/{index:05d}/samples/0000.png + metadata.jsonl) so the
official detector/judge scorers consume it unchanged.

  python -m bagel_tpu_torch.eval.gen_runner --checkpoint ... \
      --metadata geneval_metadata.jsonl --outdir results/ \
      [--think] [--image_root edits/] [--cfg_text_scale 4.0] [--device cpu]

The engine runs on CUDA unless `--device` names another device. `run_gen`
is the loop over the rows, for a caller that holds an engine already. Row
i's x_1 is drawn from a torch.Generator seeded seed + i on the engine's
device, so the same seed gives another image than the JAX package's
PRNGKey(seed + i). Rows are sharded over the processes of the
torch.distributed group, which `main` starts under torchrun
(WORLD_SIZE > 1).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List


def run_gen(engine, vae_transform, rows: List[dict], outdir: str, args,
            rank: int = 0, world: int = 1) -> List[int]:
    """Generate rows[rank::world] into the GenEval layout under `outdir`,
    skipping a row whose image exists. `args` carries the generation
    settings of `main`'s flags. Returns the indexes generated."""
    import torch
    from PIL import Image

    from bagel_tpu_torch.data.transforms import pil_img2rgb

    done = []
    for row in rows[rank::world]:
        sample_dir = os.path.join(outdir, f"{row['index']:05d}")
        out_path = os.path.join(sample_dir, "samples", "0000.png")
        if os.path.exists(out_path):  # resumable (gen_images_mp.py:203-210)
            continue
        os.makedirs(os.path.join(sample_dir, "samples"), exist_ok=True)
        with open(os.path.join(sample_dir, "metadata.jsonl"), "w") as f:
            f.write(json.dumps(row) + "\n")

        image = None
        shapes = (args.image_size, args.image_size)
        if row.get("image"):
            src = pil_img2rgb(
                Image.open(os.path.join(args.image_root, row["image"]))
            )
            image = vae_transform(src)
            shapes = image.shape[:2]

        out = engine(
            image=image,
            text=row["prompt"],
            think=args.think,
            image_shapes=shapes,
            num_timesteps=args.num_timesteps,
            cfg_text_scale=args.cfg_text_scale,
            cfg_img_scale=args.cfg_img_scale,
            cfg_renorm_type=args.cfg_renorm_type,
            cfg_renorm_min=args.cfg_renorm_min,
            cfg_interval=(args.cfg_interval_min, 1.0),
            timestep_shift=args.timestep_shift,
            enable_taylorseer=args.enable_taylorseer,
            rng=torch.Generator(device=engine.device).manual_seed(args.seed + row["index"]),
        )
        Image.fromarray(out["image"]).save(out_path)
        if out.get("text"):
            with open(os.path.join(sample_dir, "thinking.txt"), "w") as f:
                f.write(out["text"])
        print(f"[{rank}] generated {row['index']:05d}")
        done.append(row["index"])
    return done


def parse_args(argv=None):
    p = argparse.ArgumentParser("bagel_tpu_torch gen eval")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--mesh", type=str, default=None,
                   help="dp,fsdp,tp: not ported yet (raises)")
    p.add_argument("--device", type=str, default=None,
                   help="the engine's device (default: CUDA)")
    p.add_argument("--metadata", type=str, required=True,
                   help="jsonl rows with at least {'prompt': ...}; optional "
                        "'image' column turns rows into editing tasks")
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--image_root", type=str, default="")
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--num_timesteps", type=int, default=50)
    p.add_argument("--cfg_text_scale", type=float, default=4.0)
    p.add_argument("--cfg_img_scale", type=float, default=1.0)
    p.add_argument("--cfg_renorm_type", type=str, default="global")
    p.add_argument("--cfg_renorm_min", type=float, default=0.0)
    p.add_argument("--cfg_interval_min", type=float, default=0.4,
                   help="CFG active for t in (interval_min, 1.0]")
    p.add_argument("--timestep_shift", type=float, default=3.0)
    p.add_argument("--think", action="store_true")
    p.add_argument("--enable_taylorseer", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max_kv", type=int, default=8192)
    p.add_argument("--max_latent_size", type=int, default=64)
    p.add_argument("--quant", type=str, default=None,
                   choices=[None, "int8", "w8a8", "int4", "nf4"],
                   help="serve the eval model quantized (serving/app.py "
                        "--quant semantics)")
    p.add_argument("--no_fuse", action="store_true",
                   help="keep separate q/k/v and gate/up projections")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from bagel_tpu_torch.serving.app import build_engine
    from bagel_tpu_torch.utils.device import process_rank_world, resolve_device

    # the group first: under torchrun it picks each process's card
    rank, world, started = process_rank_world(resolve_device(args.device))
    try:
        engine, vae_tf, _ = build_engine(args)

        rows: List[dict] = []
        with open(args.metadata) as f:
            for i, line in enumerate(f):
                if line.strip():
                    row = json.loads(line)
                    row.setdefault("index", i)
                    rows.append(row)
        run_gen(engine, vae_tf, rows, args.outdir, args, rank, world)
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
