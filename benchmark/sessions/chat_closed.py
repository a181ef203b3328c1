"""Chat through `ServingRuntime.submit_chat`: a closed loop of `clients`
threads, each sending its next request when its last has finished.

The clients start together; the first requests warm the path up (the
decode graph's capture, an image admission) and count as set-up. The
window opens once `warmup_requests` have finished, one with an image among
them, and lasts `--seconds`; then the clients stop sending and the
requests in flight finish. Tokens count where `on_tokens` delivers them
inside the window; the time to first token counts for every request sent
inside it (a failed request's as infinite).

The check: a sample of the window's finished requests drawn from the seed,
the one with the most served tokens among them. The plain reference runs
each prompt (its image through its own SigLIP) with the served tokens, and
the widest gap by which a served token's logit lies below the reference's
best at its position is compared.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from benchmark.harness import program
from benchmark.harness.draws import rng
from benchmark.harness.tokens import prompt_ids, special
from benchmark.harness.weights import make_params
from benchmark.reference import bagel as ref
from benchmark.traffic import chat_closed as traffic


def setup(run) -> None:
    from bagel_tpu_torch.serving.runtime import ServingRuntime

    p = run.traffic
    t = time.perf_counter()
    if run.device.type == "cuda":
        program.build_kernels()
    parts = run.state["setup_parts"] = {"build_s": time.perf_counter() - t}
    t = time.perf_counter()
    params = make_params(run.model, run.seed, run.device, run.dtype)
    parts["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    eng = program.engine(run, params)
    parts["engine_s"] = time.perf_counter() - t
    run.state["rt"] = ServingRuntime(eng, slots=p["slots"], decode_chunk=p["decode_chunk"])
    run.state["pool"] = traffic.draw(p, run.seed)
    run.state["rt"].start()


def _client(run, c: int, reqs: list, stop: threading.Event, lock: threading.Lock):
    rt, bases = run.state["rt"], run.state["pool"]["bases"]
    timeout = run.traffic["request_timeout_s"]
    i = 0
    while not stop.is_set():
        req = reqs[i % len(reqs)]
        i += 1
        img = None if req["image"] is None else traffic.to_float(bases, req["image"])
        rec = {"id": req["id"], "client": c, "prompt": req["prompt"], "image": req["image"],
               "max_new_tokens": req["max_new_tokens"], "chunks": []}

        def on_tokens(ids, rec=rec):
            rec["chunks"].append((time.perf_counter(), list(ids)))

        rec["t_send"] = time.perf_counter()
        fut = rt.submit_chat(req["prompt"], image=img, max_new_tokens=req["max_new_tokens"],
                             on_tokens=on_tokens)
        try:
            rec["text"] = fut.result(timeout=timeout)
            rec["ok"] = True
        except Exception as e:  # noqa: BLE001  a failed request counts as failed
            rec["ok"], rec["error"] = False, repr(e)
        rec["t_done"] = time.perf_counter()
        with lock:
            run.log.append(rec)


def served(rec) -> list:
    return [t for _, ids in rec["chunks"] for t in ids]


def window(run) -> None:
    p, rt = run.traffic, run.state["rt"]
    stop, lock = threading.Event(), threading.Lock()
    threads = [threading.Thread(target=_client, args=(run, c, reqs, stop, lock), daemon=True)
               for c, reqs in enumerate(run.state["pool"]["clients"])]
    t_go = time.perf_counter()
    for t in threads:
        t.start()
    deadline = time.perf_counter() + p["warmup_timeout_s"]
    while time.perf_counter() < deadline:
        with lock:
            done = [r for r in run.log if r["ok"]]
        if len(done) >= p["warmup_requests"] and any(r["image"] for r in done):
            break
        time.sleep(0.01)
    run.t_start = time.perf_counter()
    parts = run.state.setdefault("setup_parts", {})
    parts["warmup_s"] = run.t_start - t_go
    parts["capture_s"] = getattr(rt.decode, "capture_s", None)  # the decode graphs' capture
    run.counters["start"] = dict(rt.stats)
    end = run.t_start + run.seconds
    # the traced slice is the window's last trace_seconds; the profiler
    # stops once the requests in flight have finished and the runtime has
    # stopped
    t_trace = end - min(p["trace_seconds"], run.seconds)
    while time.perf_counter() < t_trace:
        time.sleep(0.005)
    run.tracer.start()
    while time.perf_counter() < end:
        time.sleep(0.005)
    run.t_end = end
    run.tracer.end()
    stop.set()
    run.counters["end"] = dict(rt.stats)
    for t in threads:
        t.join(p["request_timeout_s"] + 5)
    rt.stop()
    run.tracer.stop()
    hung = sum(t.is_alive() for t in threads)
    sent = [r for r in run.log if run.t_start <= r["t_send"] < run.t_end]
    run.attempted = len(sent) + hung
    run.failed = sum(not r["ok"] for r in sent) + hung
    tokens = sum(len(ids) for r in run.log for t, ids in r["chunks"]
                 if run.t_start <= t <= run.t_end)
    run.values["chat_tokens_per_s"] = tokens / run.window_s
    ttft = sorted(r["chunks"][0][0] - r["t_send"] if r["ok"] and r["chunks"] else float("inf")
                  for r in sent)
    if ttft:  # nearest rank: a run sends ~160 requests, 16 lie beyond its 90th percentile
        run.values["chat_ttft_p90_s"] = ttft[max(0, int(np.ceil(0.90 * len(ttft))) - 1)]


def free(run) -> None:
    run.state.pop("rt", None)


def check(run) -> None:
    """logit_gap: the widest gap, over the sample's served tokens, between
    the reference's best logit and its logit of the served token;
    served_text: served tokens whose ids the answer's text disagrees with."""
    p, lim, model = run.traffic, run.cell["limits"], run.model
    sent = [r for r in run.log if r["ok"] and run.t_start <= r["t_send"] < run.t_end]
    if not sent:
        return
    g = rng(run.seed, 11)
    longest = max(range(len(sent)), key=lambda i: len(served(sent[i])))
    rest = [i for i in range(len(sent)) if i != longest]
    pick = [longest] + [int(i) for i in g.choice(rest, min(len(rest), p["check_requests"] - 1),
                                                 replace=False)]
    ref.fp32_mode()
    params = make_params(model, run.seed, run.device, run.dtype)
    vocab = model["llm"]["vocab_size"]
    ids = special(vocab)
    bases = run.state["pool"]["bases"]
    widest, mismatched = 0.0, 0
    for i in pick:
        r = sent[i]
        toks = served(r)
        mismatched += r["text"] != " ".join(str(t) for t in toks)
        if not toks:
            continue
        img = None if r["image"] is None else traffic.to_float(bases, r["image"])
        with torch.no_grad():
            lg = ref.chat_logits(params, model, prompt_ids(r["prompt"], vocab), img, toks, ids)
            t = torch.as_tensor(toks, device=lg.device)
            gap = lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]
        widest = max(widest, float(gap.max()))
    run.compare("logit_gap", widest, lim["logit_gap"])
    run.compare("served_text", mismatched, 0)
    run.state["checked"] = {"ids": [sent[i]["id"] for i in pick],
                            "tokens": sum(len(served(sent[i])) for i in pick)}
