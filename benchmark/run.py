"""Run one cell of the benchmark of bagel_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The cell is BENCHMARK.json's entry of that name: its configuration
(`benchmark/configs/<config>.json`), its traffic mix
(`benchmark/traffic/<traffic>.json`, whose `kind` names the generator
`benchmark/traffic/<kind>.py` and the session `benchmark/sessions/<kind>.py`)
and its check limits (`benchmark/workloads/<name>.json`). Set-up builds the weights from the seed
and the system under test, and warms up every shape the cell uses; the
window measures for `--seconds`; the check compares what the window
produced with the plain reference (`benchmark/reference/`). With --trace 0
the last line of standard output holds the cell's end-to-end metrics
(BENCHMARK.json), with --trace 1 its per-layer metrics
(`benchmark/metrics/<name>.py`, one reader each) and the device's busy
time in the traced window. Each compared number and its limit go to
standard error and into the result, last.

It refuses to run (a non-zero exit, no result) without CUDA or with fewer
cards than the cell asks for, and when `jax`, `jaxlib`, `flax` or
`bagel_tpu` is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
# every cache of the program and its libraries inside the checkout, at a
# fixed path: only a checkout's first run builds
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(BUILD, "cuda_cache")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)

FORBIDDEN = {"jax", "jaxlib", "flax", "bagel_tpu"}


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `bagel_tpu_torch` is not `bagel_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def load_cell(bench: dict, workload: str) -> dict:
    """The cell's entry in BENCHMARK.json with its traffic mix
    (`benchmark/traffic/<traffic>.json`) in place of the mix's name, and
    its check limits (`benchmark/workloads/<name>.json`)."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"benchmark: no workload {workload!r} in BENCHMARK.json")
    cell = dict(entry)
    cell["traffic"] = load_json("benchmark", "traffic", f"{entry['traffic']}.json")
    cell.update(load_json("benchmark", "workloads", f"{workload}.json"))
    return cell


def cell_metrics(bench: dict, workload: str, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") this cell
    reports: those that list it, or list no cells."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def read_metric(name: str, run):
    path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(argv=None, need_card: bool = True, device=None):
    """One run: (the run's record, its result). `need_card=False` and a
    `device` skip the look for a card (the tests drive a run on the CPU)."""
    args = parse(argv)
    bench = load_json("BENCHMARK.json")
    cell = load_cell(bench, args.workload)
    config = load_json("benchmark", "configs", f"{cell['config']}.json")

    import torch

    from benchmark.harness.runstate import Run
    from benchmark.harness.trace import Tracer, prime

    if need_card:
        if not torch.cuda.is_available():
            raise SystemExit("benchmark: torch.cuda.is_available() is False; no result")
        if torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"benchmark: the cell needs {cell['chips']} card(s), "
                             f"{torch.cuda.device_count()} found; no result")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    # the configuration's float32 parts (the VAE) run in float32: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    session = importlib.import_module(f"benchmark.sessions.{cell['traffic']['kind']}")
    run = Run(cell=cell, config=config, seed=args.seed,
              seconds=args.seconds, device=device,
              tracer=Tracer(bool(args.trace) and need_card, device))
    t_setup = time.perf_counter()
    session.setup(run)
    run.state.setdefault("setup_parts", {})["start_s"] = t_setup - T0
    if run.tracer.enabled and not prime(device):
        print("benchmark: the profiler recorded no device activity", file=sys.stderr)
    if need_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    session.window(run)
    setup_s = run.t_start - T0
    peak = torch.cuda.max_memory_allocated(device) if need_card else 0
    run.tracer.collect()
    session.free(run)
    gc.collect()
    if need_card:
        torch.cuda.empty_cache()
    session.check(run)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"benchmark: loaded in this process: {', '.join(found)}; no result")

    metrics = {}
    if not args.trace:
        run.values["setup_s"] = setup_s
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            if m["name"] in run.values:
                metrics[m["name"]] = {"value": run.values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, args.workload, "per_layer"):
            v = read_metric(m["name"], run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if need_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if need_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if args.trace and run.tracer.window_s is not None:
        dev["busy_s"] = run.tracer.busy_s()
        dev["window_s"] = run.tracer.window_s
        result["breakdown"] = run.tracer.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.comparisons}
    result["checks"]["failed_requests"] = {"value": run.failed, "limit": 0}
    return run, result


def main(argv=None, need_card: bool = True, device=None) -> dict:
    """One run; prints each compared number beside its limit as the last
    lines of standard error, and the result as the last line of standard
    output; returns the result."""
    run, result = execute(argv, need_card, device)
    if run.state.get("setup_parts"):
        print("setup " + json.dumps(run.state["setup_parts"]), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    import faulthandler

    # a run that has not ended by now never will: every thread's stack to
    # standard error, and out with a non-zero code, well inside the 360 s
    # a run is allowed
    faulthandler.dump_traceback_later(330, exit=True)
    main()
