"""Worker processes for the port's distributed tests.

`run(fn, world, tmp_path, **kw)` starts `world` Python processes that join
one gloo group through a FileStore under `tmp_path` (no TCP port, so tests
run side by side under xdist), calls the function `fn` of this module in
each with `kw` and returns what each returned, in rank order. The parent
joins them with a deadline of its own and fails when it passes (no
pytest-timeout here). Each worker takes one CPU thread.

This module imports torch, numpy and bagel_tpu_torch only: the workers
never import JAX. The JAX side runs in the pytest process and reaches the
workers as pickled numpy trees.
"""

import os
import pickle
import subprocess
import sys
import time

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(fn: str, world: int, tmp_path, deadline: float = 300.0, env=None, **kw) -> list:
    tmp = str(tmp_path)
    spec = os.path.join(tmp, f"{fn}.spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump(dict(fn=fn, world=world, kw=kw, store=os.path.join(tmp, f"{fn}.store"),
                         deadline=deadline), f)
    penv = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1", **(env or {}))
    logs = [open(os.path.join(tmp, f"{fn}.rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), spec, str(r)],
                              cwd=tmp, env=penv, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    end = time.monotonic() + deadline
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{fn}: workers still running after {deadline} s:\n"
                             + _tails(logs))
    if any(p.returncode for p in procs):
        raise AssertionError(f"{fn}: worker exit codes {[p.returncode for p in procs]}:\n"
                             + _tails(logs))
    out = []
    for r in range(world):
        with open(f"{spec}.out{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


def _tails(logs) -> str:
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r} ---\n{f.read()[-3000:]}")
    return "\n".join(text)


def _main(spec_path: str, rank: int) -> None:
    import faulthandler

    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    # a hung worker prints its stacks into its log before the parent kills it
    faulthandler.dump_traceback_later(max(spec["deadline"] - 10, 1), exit=True)
    world = spec["world"]
    dist.init_process_group("gloo", store=dist.FileStore(spec["store"], world), rank=rank,
                            world_size=world)
    try:
        result = globals()[spec["fn"]](**spec["kw"])
        with open(f"{spec_path}.out{rank}", "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _unshard_tree(layout, tree):
    """Every leaf of a sharded tree in full (collective)."""
    from bagel_tpu_torch.parallel.mesh import leaf_paths

    return {p: (None if t is None else layout.unshard(p, t).numpy())
            for p, t in leaf_paths(tree)}


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------


def train_step(shape, params, cfg, batch, noise, lr, ema_decay):
    """One sharded train step on the (dp, fsdp, tp) mesh `shape` from the
    full numpy params; returns (global loss, grads, params, ema, mu) with
    every tree unsharded to {path: array}."""
    from bagel_tpu_torch.models.bagel import PackedTrainBatch
    from bagel_tpu_torch.parallel.mesh import Layout, make_mesh, shard_batch, shard_params
    from bagel_tpu_torch.train import step as tstep
    from bagel_tpu_torch.utils.bridge import params_from_numpy

    mesh = make_mesh(tuple(shape))
    layout = Layout(mesh, cfg)
    local = shard_params(layout, params_from_numpy(params, "cpu"))
    tx = tstep.make_optimizer(tstep.make_lr_schedule(lr, warmup_steps=0), max_grad_norm=1.0)
    state = tstep.init_train_state(local, tx, use_ema=True)
    tb = shard_batch(mesh, PackedTrainBatch(**{k: torch.tensor(v) for k, v in batch.items()}))
    tnoise = shard_batch(mesh, torch.tensor(noise))
    grads, _ = tstep.grad_step(state.params, cfg, tb, tnoise, layout, ce_weight=1.0,
                               mse_weight=1.0)
    step = tstep.make_train_step(cfg, tx, ce_weight=1.0, mse_weight=1.0, ema_decay=ema_decay,
                                 layout=layout)
    state, metrics = step(state, tb, noise=tnoise)
    return dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                grads=_unshard_tree(layout, grads), params=_unshard_tree(layout, state.params),
                ema=_unshard_tree(layout, state.ema_params),
                mu=_unshard_tree(layout, state.opt_state["mu"]))


def _grads(layout, cfg, params, batch, noise, **kw):
    """(global loss, unsharded reduced grads) of one grad_step."""
    from bagel_tpu_torch.models.bagel import PackedTrainBatch
    from bagel_tpu_torch.parallel.mesh import shard_batch, shard_params
    from bagel_tpu_torch.train import step as tstep
    from bagel_tpu_torch.utils.bridge import params_from_numpy

    local = shard_params(layout, params_from_numpy(params, "cpu"))
    tstep.set_trainable(local)
    tb = shard_batch(layout.mesh, PackedTrainBatch(**{k: torch.tensor(v) for k, v in batch.items()}))
    grads, metrics = tstep.grad_step(local, cfg, tb, shard_batch(layout.mesh, torch.tensor(noise)),
                                     layout, ce_weight=1.0, mse_weight=1.0, **kw)
    return dict(loss=float(metrics["loss"]), grads=_unshard_tree(layout, grads))


def ring_cases(cases):
    """Each case {q, k, v (full [B, S, H, D]), sp, causal, ids}: the ring over
    sp ranks of this world (a mesh (world / sp, sp)), its output gathered."""
    from bagel_tpu_torch.ops.ring import ring_attention, ring_packed_attention
    from bagel_tpu_torch.parallel.mesh import gather_seq, make_mesh

    outs = []
    for c in cases:
        mesh = make_mesh((dist.get_world_size() // c["sp"], c["sp"]), axes=("x", "sp"))
        group, n, i = mesh.group("sp"), c["sp"], mesh.index("sp")
        q, k, v = (torch.tensor(c[x]).chunk(n, dim=1)[i] for x in ("q", "k", "v"))
        if c.get("ids") is not None:
            ids = [torch.tensor(t).chunk(n)[i] for t in c["ids"]]
            out = ring_packed_attention(q, k, v, *ids, group, q_chunk=c.get("q_chunk"))
        else:
            out = ring_attention(q, k, v, group, causal=c["causal"], q_chunk=c.get("q_chunk"))
        outs.append(gather_seq(out, 1, group).numpy())
    return outs


def cp_grads(shape, axis, params, cfg, batch, noise, attn_chunk=None):
    """compute_losses' gradients with context_parallel over `axis`."""
    from bagel_tpu_torch.parallel.mesh import Layout, make_mesh

    mesh = make_mesh(tuple(shape))
    layout = Layout(mesh, cfg, context_axis=axis)
    return _grads(layout, cfg, params, batch, noise, context_parallel=(mesh, axis),
                  attn_chunk=attn_chunk)


def pp_grads(pp, params, cfg, batch, noise, attn_chunk=None):
    """compute_losses' gradients with the rows as GPipe microbatches over a
    pp-way stage axis."""
    from bagel_tpu_torch.parallel.mesh import Layout, make_mesh

    mesh = make_mesh((pp,), axes=("pp",))
    layout = Layout(mesh, cfg, pipeline_axis="pp")
    return _grads(layout, cfg, params, batch, noise, pipeline_parallel=(mesh, "pp"),
                  attn_chunk=attn_chunk)


def ep_grads(params, cfg, batch, noise, attn_chunk=None):
    """compute_losses' gradients with the MoT experts over a 2-way axis."""
    from bagel_tpu_torch.parallel.mesh import Layout, make_mesh

    mesh = make_mesh((2,), axes=("ep",))
    layout = Layout(mesh, cfg, expert_axis="ep")
    return _grads(layout, cfg, params, batch, noise, expert_parallel=(mesh, "ep"),
                  attn_chunk=attn_chunk)


def placed_init(cfg, shape, axes, expert_axis=None):
    """init_bagel_params(place=layout.shard) against shard_params of the
    whole tree's init: the same paths, every local leaf equal, and the
    shapes the layout recorded equal to the whole leaves'."""
    from bagel_tpu_torch.models.bagel import init_bagel_params
    from bagel_tpu_torch.parallel.mesh import Layout, leaf_paths, make_mesh, shard_params

    mesh = make_mesh(tuple(shape), axes=tuple(axes))
    whole = init_bagel_params(torch.Generator().manual_seed(0), cfg, torch.float32, device="cpu")
    want = leaf_paths(shard_params(Layout(mesh, cfg, expert_axis=expert_axis), whole))
    layout = Layout(mesh, cfg, expert_axis=expert_axis)
    got = leaf_paths(init_bagel_params(torch.Generator().manual_seed(0), cfg, torch.float32,
                                       device="cpu", place=layout.shard))
    return dict(paths=[p for p, _ in want] == [p for p, _ in got], leaves=len(got),
                equal=all(torch.equal(a, b) for (_, a), (_, b) in zip(want, got)),
                shapes=layout.shapes == {p: tuple(t.shape) for p, t in leaf_paths(whole)},
                sharded=sum(a.numel() for _, a in got) < sum(t.numel() for _, t in
                                                             leaf_paths(whole)))


def _register(dataset):
    from bagel_tpu_torch.data.datasets import register_dataset_info

    group, name, data_dir = dataset
    register_dataset_info(group, name, data_dir=data_dir)


def driver_run(argv, dataset):
    """The train driver under this process group."""
    from bagel_tpu_torch.train import driver

    _register(dataset)
    _, history = driver.main(argv)
    return dict(history=history)


def driver_resume(argv, dataset):
    """Two steps with a save, an --auto_resume of them (the restored
    parameters against the saved run's, every leaf unsharded), then one step
    more."""
    from bagel_tpu_torch.parallel.mesh import leaf_paths
    from bagel_tpu_torch.train import driver

    _register(dataset)
    layouts = []
    make = driver.make_layout
    driver.make_layout = lambda *a: layouts.append(make(*a)) or layouts[-1]
    first, _ = driver.main(argv + ["--total_steps", "2"])
    saved = {p: layouts[-1].unshard(p, t) for p, t in leaf_paths(first.params)}
    again, history = driver.main(argv + ["--total_steps", "2", "--auto_resume"])
    same = all(torch.equal(saved[p], layouts[-1].unshard(p, t))
               for p, t in leaf_paths(again.params))
    _, more = driver.main(argv + ["--total_steps", "3", "--auto_resume"])
    return dict(resumed_history=history, bit_equal=same, step=again.step,
                continued=[h["step"] for h in more])


def serve_two(tree, cfg, prompts, runtime):
    """serve_multihost over this group: each process builds the same engine;
    the leader sends `prompts` as chats and stops, the follower ticks until
    then."""
    from bagel_tpu_torch.data.tokenizer import MockTokenizer
    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.serving.multihost import TorchDistBus, serve_multihost
    from bagel_tpu_torch.utils.bridge import params_from_numpy

    tok = MockTokenizer(cfg.llm.vocab_size)
    engine = BagelEngine(params_from_numpy(tree, "cpu"), cfg, tok, tok.new_token_ids,
                         max_kv=512, device="cpu")
    fe = serve_multihost(engine, **runtime)
    assert isinstance(fe.bus, TorchDistBus) and fe.leader == (dist.get_rank() == 0)
    fe.start()
    answers = None
    if fe.leader:
        answers = [f.result(timeout=240) for f in [fe.submit_chat(p) for p in prompts]]
        fe.stop()
    else:
        fe.join(timeout=280)
    assert fe.error is None, fe.error
    return dict(answers=answers, ticks=fe.ticks, stats=dict(fe.stats))


def row_parallel_w8a8(tp, cases):
    """Each case {x [M, K] (bf16 values), w_q8 [K, N], scale [N]} as a
    row-parallel w8a8 linear over the tp group (`InferenceTP`): this rank's
    slice of K through `qwen2._linear` (its partial sums all-reduced, then
    rounded to bf16), with the codes and scales it quantized; and the
    control, each slice quantized with its own scale (the plain per-slice
    quantization), its partial sums all-reduced and rounded the same way."""
    from bagel_tpu_torch.models import qwen2
    from bagel_tpu_torch.ops.int8_matmul import int8_matmul_plain, quantize_rows_plain

    rank = dist.get_rank(tp.group)
    out = []
    for c in cases:
        x = torch.tensor(c["x"]).bfloat16().chunk(tp.n, dim=-1)[rank]
        leaf = dict(w_q8=torch.tensor(c["w_q8"]).chunk(tp.n, dim=0)[rank],
                    scale=torch.tensor(c["scale"]))
        codes, scales = qwen2.quantize_activations(x, tp)
        y = tp.leave(qwen2._linear(x, leaf, tp=tp)).bfloat16()
        own_q, own_s = quantize_rows_plain(x)
        ctl = int8_matmul_plain(own_q, own_s, leaf["w_q8"], leaf["scale"], out_dtype=torch.float32)
        dist.all_reduce(ctl, group=tp.group)
        out.append(dict(codes=codes.numpy(), scale=scales.numpy(), out=y.float().numpy(),
                        control=ctl.bfloat16().float().numpy()))
    return out


def sharded_paths(shapes, jobs, linears=()):
    """Every inference path of a sharded engine, for each (dp, fsdp, tp)
    mesh of `shapes` over this world. Each job {name, cfg, tree, work,
    chats}: its numpy tree (quantized on the whole leaf where it is) placed
    leaf by leaf (`params_from_numpy(layout=)`) and fused; the
    text-to-image latent from `work["noise"]`; with `chats` the greedy
    understanding answer, the serving runtime's answers over the sharded
    slot cache (plain and speculative) and the slot cache's local part.
    At tp = world, the `linears` cases (`row_parallel_w8a8`) as well.
    Returns {shape: {name: {...}}}."""
    from bagel_tpu_torch.data.tokenizer import MockTokenizer
    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.models.qwen2 import fuse_llm_params, kv_cache_init
    from bagel_tpu_torch.parallel.mesh import InferenceLayout, make_mesh, shard_cache
    from bagel_tpu_torch.serving.runtime import ServingRuntime
    from bagel_tpu_torch.utils.bridge import params_from_numpy

    out = {}
    for shape in shapes:
        mesh = make_mesh(tuple(shape))
        out[tuple(shape)] = per_job = {}
        if linears and shape[2] == dist.get_world_size():
            cfg = jobs[0]["cfg"]
            per_job["linears"] = row_parallel_w8a8(InferenceLayout(mesh, cfg).tp, linears)
        for job in jobs:
            cfg, work = job["cfg"], job["work"]
            tok = MockTokenizer(cfg.llm.vocab_size)
            layout = InferenceLayout(mesh, cfg)
            params = params_from_numpy(job["tree"], "cpu", layout=layout)
            params["llm"] = fuse_llm_params(params["llm"], inplace=True)
            eng = BagelEngine(params, cfg, tok, tok.new_token_ids, max_kv=512, device="cpu",
                              layout=layout)
            ctx = eng.init_context()
            cfg_text, cfg_img = ctx.copy(), ctx.copy()
            ctx = eng.update_context_text(work["prompt"], ctx)
            cfg_img = eng.update_context_text(work["prompt"], cfg_img)
            res = per_job[job["name"]] = dict(latent=eng.gen_image(
                work["shape"], ctx, cfg_text_precontext=cfg_text, cfg_img_precontext=cfg_img,
                init_noise=work["noise"], return_latent=True, **work["gen"]))
            if not job.get("chats"):
                continue
            res["understand"] = eng(image=work["image"], text=work["question"],
                                    understanding_output=True,
                                    max_think_token_n=work["max_new"])["text"]
            for spec in (0, 2):
                rt = ServingRuntime(eng, slots=2, decode_chunk=3, max_new_default=work["max_new"],
                                    mesh=eng.mesh, speculative=spec)
                rt.start()
                try:
                    futs = [rt.submit_chat(p, image=im) for p, im in job["chats"]]
                    res[f"serve_{spec}"] = [f.result(timeout=120) for f in futs]
                finally:
                    rt.stop()
            whole = kv_cache_init(cfg.llm, 2, 8, torch.float32, device="cpu")
            whole.k.normal_()
            part = shard_cache(layout, whole, 2)
            res["cache"] = dict(local=tuple(rt.cache.k.shape), shard=tuple(part.k.shape),
                                rows=layout.slot_rows(2), kv_heads=layout.kv_heads,
                                shard_k=part.k.numpy(), whole_k=whole.k.numpy())
    return out


def serve_main(argv, prompt):
    """serving.server.main under this group: the leader answers one chat
    over HTTP and shuts its server down, the follower ticks until then."""
    import json
    import threading
    import urllib.request

    from bagel_tpu_torch.serving import server

    made = []
    serve = server.serve
    server.serve = lambda *a, **k: made.append(serve(*a, **k)) or made[-1]
    if dist.get_rank() != 0:
        server.main(argv)
        return dict(answer=None)
    t = threading.Thread(target=server.main, args=(argv,), daemon=True)
    t.start()
    end = time.monotonic() + 240
    while not made and time.monotonic() < end:
        time.sleep(0.05)
    port = made[0].server_address[1]
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat",
                                 data=json.dumps(dict(prompt=prompt, max_tokens=6)).encode(),
                                 headers={"Content-Type": "application/json"})
    answer = json.loads(urllib.request.urlopen(req, timeout=240).read())["text"]
    made[0].shutdown()
    t.join(timeout=120)
    return dict(answer=answer, stopped=not t.is_alive())


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]))
