"""The readings a cell's check limits are set from: the numbers the check
compares, over many seeds, for the program as the benchmark runs it and for
the control, each part one step below the precision the configuration
states: the program's own w8a8 path for the bf16 decoder (weights and
activations in int8), TF32 for the float32 VAE and products, and the
float32 CFG combination in bfloat16.

    python3 benchmark/tools/readings.py --workload <name> --seeds 1,2,3 \
        --seconds 1 [--control w8a8] [--out readings.jsonl]

Each seed runs set-up, a short window at the cell's own load and the check
in this one process, as a run does, and prints one JSON line of the
compared numbers (the cell's limits are not applied). Needs a card.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import importlib

    import torch

    from benchmark import run as bench_run
    from benchmark.harness.runstate import Run
    from benchmark.harness.trace import Tracer

    bench = bench_run.load_json("BENCHMARK.json")
    cell = bench_run.load_cell(bench, args.workload)
    config = bench_run.load_json("benchmark", "configs", f"{cell['config']}.json")
    session = importlib.import_module(f"benchmark.sessions.{cell['traffic']['kind']}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = Run(cell=cell, config=config, seed=seed, seconds=args.seconds,
                  device=device, tracer=Tracer(False))
        if args.control:
            run.state["quant"] = args.control
        tf32 = bool(args.control)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        session.setup(run)
        session.window(run)
        session.free(run)
        gc.collect()
        torch.cuda.empty_cache()
        session.check(run)
        line = {"workload": args.workload, "seed": seed, "control": args.control or None,
                "attempted": run.attempted, "failed": run.failed,
                "readings": {n: v for n, v, _ in run.comparisons},
                "checked": run.state.get("checked"), "values": run.values,
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(os.path.join(ROOT, args.out), "a") as f:
                f.write(json.dumps(line) + "\n")
        del run
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
