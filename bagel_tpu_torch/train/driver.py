"""Training driver CLI (port of bagel_tpu/train/driver.py, the reference's
pretrain_unified_navit.py rebuilt).

Usage:
  python -m bagel_tpu_torch.train.driver --dataset_config data.yaml \
      --ckpt_dir ckpts --total_steps 1000 [--auto_resume] ...

  torchrun --nproc_per_node 4 -m bagel_tpu_torch.train.driver --mesh 2,2,1 ...

One process a card (`--device cpu` runs on the CPU, as the tests do; with
no device and no card it raises). The flags are the JAX driver's: gradient
accumulation, EMA, CE/MSE weighting, warmup schedules, MFU logging,
periodic checkpointing with exact data resume, optimizer and EMA offload
(pinned host memory between steps), `--profile_dir`, `--auto_resume`,
`--resume_from`, `--resume_model_only`, `--finetune_from_ema`, and a
device-OOM log before the re-raise.

Parallel runs start under torchrun (RANK, WORLD_SIZE, LOCAL_RANK): the
process group is nccl on CUDA (rank r on card LOCAL_RANK) and gloo on the
CPU, and `--mesh dp,fsdp,tp` (default 1,WORLD_SIZE,1, as JAX's) must have
WORLD_SIZE processes. The state is sharded by `parallel.mesh`'s table
(each leaf drawn whole and sharded at once: no process holds the tree);
`--context_parallel AXIS` (ring attention), `--pipeline_parallel AXIS`
(GPipe over `--pp_microbatches` rows, dp = 1) and `--expert_parallel AXIS`
(the MoT experts, an axis of 2; not with --sparse_block) are exclusive,
as JAX asserts. Every process packs the same stream (JAX's one process);
a micro-step stacks dp sequences (JAX's one sequence a dp slice; under
the pipeline its microbatches) and each dp coordinate takes its rows. Rank
0 alone logs and writes checkpoints, streamed one gathered leaf at a time
(a save under a mesh blocks); the data status of every rank is gathered
into them.

`main` returns the final TrainState and the per-step records (loss,
seconds, tokens, the analytic model TFLOP of the step, peak device memory
on CUDA), for callers that check a run.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import time

import torch

from bagel_tpu_torch.configs import BagelConfig, Qwen2Config, SiglipConfig, VAEConfig
from bagel_tpu_torch.data.datasets import build_grouped_datasets
from bagel_tpu_torch.data.packing import PackedBatchIterator, PackerConfig, stack_batches
from bagel_tpu_torch.models.bagel import init_bagel_params
from bagel_tpu_torch.parallel.mesh import Layout, Mesh, shard_batch, shard_params
from bagel_tpu_torch.train.checkpoint import (
    data_status_for_process,
    gather_data_status,
    get_latest_ckpt,
    restore_checkpoint,
    restore_params_only,
    save_checkpoint,
    step_from_path,
    update_data_status,
    wait_for_saves,
)
from bagel_tpu_torch.train.step import (
    ema_update_,
    grad_step,
    init_train_state,
    make_lr_schedule,
    make_optimizer,
    tree_leaves,
    tree_map,
)
from bagel_tpu_torch.utils.device import resolve_device
from bagel_tpu_torch.utils.metrics import ThroughputMeter, make_logger, profile_trace

def seqlen_sq(document_id: torch.Tensor) -> float:
    """Sum over packed samples of len(sample)^2, the attention term of the
    analytic FLOPs model (pretrain_unified_navit.py:675-681). document_id:
    [B, S], 0 = padding."""
    total = 0.0
    for row in document_id:
        counts = torch.bincount(row[row > 0].long())
        total += float((counts.double() ** 2).sum())
    return total


def parse_args(argv=None):
    p = argparse.ArgumentParser("bagel_tpu_torch trainer")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default CUDA (raises without a card)")
    # model
    p.add_argument("--preset", type=str, default="7b", choices=["7b", "micro"],
                   help="micro = 1-layer config for smoke tests/CI")
    p.add_argument("--mock_tokenizer", action="store_true",
                   help="use the deterministic test tokenizer (no files)")
    p.add_argument("--llm_config", type=str, default=None,
                   help="json file for Qwen2Config (default 7B MoT); with --preset micro, "
                        "overrides of its fields")
    p.add_argument("--layer_module", type=str, default="mot", choices=["dense", "moe", "mot"])
    p.add_argument("--num_hidden_layers", type=int, default=None)
    p.add_argument("--visual_gen", action="store_true", default=True)
    p.add_argument("--no_visual_gen", dest="visual_gen", action="store_false")
    p.add_argument("--visual_und", action="store_true", default=True)
    p.add_argument("--no_visual_und", dest="visual_und", action="store_false")
    p.add_argument("--max_latent_size", type=int, default=32)
    p.add_argument("--timestep_shift", type=float, default=1.0)
    p.add_argument("--freeze_und", action="store_true")
    # module freezing (pretrain_unified_navit.py:541-551; the VAE is encoded
    # outside the gradient graph, so freezing it only strips its moments)
    p.add_argument("--freeze_llm", action="store_true")
    p.add_argument("--freeze_vit", action="store_true")
    p.add_argument("--freeze_vae", action="store_true", default=True)
    p.add_argument("--no_freeze_vae", dest="freeze_vae", action="store_false")
    p.add_argument("--init_checkpoint", type=str, default=None,
                   help="HF-released checkpoint dir to convert + finetune")
    # data
    p.add_argument("--dataset_config", type=str, required=False)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--expected_num_tokens", type=int, default=32768)
    p.add_argument("--max_num_tokens", type=int, default=36864)
    p.add_argument("--max_num_tokens_per_sample", type=int, default=16384)
    p.add_argument("--prefer_buffer_before", type=int, default=16384)
    p.add_argument("--max_buffer_size", type=int, default=50,
                   help="overflow-sample buffer cap (dataset_base.py:201)")
    p.add_argument("--text_cond_dropout_prob", type=float, default=0.1)
    p.add_argument("--vit_cond_dropout_prob", type=float, default=0.4)
    p.add_argument("--vae_cond_dropout_prob", type=float, default=0.1)
    p.add_argument("--num_workers", type=int, default=0,
                   help="packing worker subprocesses; 0 = in-process thread")
    # training
    p.add_argument("--total_steps", type=int, default=500_000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_scheduler", type=str, default="constant", choices=["constant", "cosine"])
    p.add_argument("--warmup_steps", type=int, default=2000)
    p.add_argument("--min_lr", type=float, default=1e-7)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.95)
    p.add_argument("--eps", type=float, default=1e-15)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--ce_weight", type=float, default=0.25)
    p.add_argument("--mse_weight", type=float, default=1.0)
    p.add_argument("--ema", type=float, default=0.9999)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--ema_offload", action="store_true",
                   help="keep the EMA tree in pinned host memory between steps")
    p.add_argument("--optimizer_offload", action="store_true",
                   help="keep the Adam moments in pinned host memory between "
                        "steps; each leaf visits the card for its update")
    p.add_argument("--mesh", type=str, default=None,
                   help="dp,fsdp,tp process mesh (product = WORLD_SIZE; default 1,WORLD_SIZE,1)")
    p.add_argument("--remat", type=str, default="full", choices=["full", "dots", "none"],
                   help="per-layer activation checkpointing: full = save the "
                        "layer input only (reference NO_REENTRANT); dots = keep "
                        "the projection outputs; none = keep everything")
    p.add_argument("--attn_chunk", type=int, default=None,
                   help="chunked packed attention (no dense [S,S] mask)")
    p.add_argument("--sparse_block", type=int, default=None,
                   help="block-sparse packed attention through the CUDA kernel "
                        "(its tiles are 128; the value selects the path)")
    p.add_argument("--context_parallel", type=str, default=None,
                   help="mesh axis of ring attention over the packed sequence (B=1 a rank; "
                        "--attn_chunk then chunks the ring block's query rows)")
    p.add_argument("--pipeline_parallel", type=str, default=None,
                   help="mesh axis of the GPipe stages over the LLM layer stack (dp = 1)")
    p.add_argument("--pp_microbatches", type=int, default=4)
    p.add_argument("--expert_parallel", type=str, default=None,
                   help="mesh axis (size 2) holding the MoT und/gen experts")
    # logging / ckpt
    p.add_argument("--ckpt_dir", type=str, default="results/ckpt")
    p.add_argument("--save_every", type=int, default=2000)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--resume_from", type=str, default=None,
                   help="train-checkpoint dir to resume/finetune from")
    p.add_argument("--resume_model_only", action="store_true",
                   help="load weights only; fresh optimizer/step/data stream")
    p.add_argument("--finetune_from_ema", action="store_true",
                   help="with --resume_model_only: start from EMA weights")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--wandb_project", type=str, default=None,
                   help="enable wandb logging (gated on install)")
    p.add_argument("--wandb_name", type=str, default=None)
    return p.parse_args(argv)


def build_config(args) -> BagelConfig:
    if args.preset == "micro":
        import json

        from bagel_tpu_torch.configs import micro_bagel

        cfg = micro_bagel()
        llm = dataclasses.replace(cfg.llm, freeze_und=args.freeze_und)
        if args.llm_config:  # overrides of the micro config's fields
            with open(args.llm_config) as f:
                llm = dataclasses.replace(llm, **json.load(f))
        if args.num_hidden_layers:
            llm = dataclasses.replace(llm, num_hidden_layers=args.num_hidden_layers)
        return dataclasses.replace(cfg, llm=llm)
    if args.llm_config:
        import json

        with open(args.llm_config) as f:
            llm = Qwen2Config(**json.load(f))
    else:
        llm = Qwen2Config(layer_module=args.layer_module, freeze_und=args.freeze_und)
    if args.num_hidden_layers:
        llm = dataclasses.replace(llm, num_hidden_layers=args.num_hidden_layers)
    return BagelConfig(
        visual_gen=args.visual_gen,
        visual_und=args.visual_und,
        llm=llm,
        vit=SiglipConfig() if args.visual_und else None,
        vae=VAEConfig() if args.visual_gen else None,
        max_latent_size=args.max_latent_size,
        timestep_shift=args.timestep_shift,
    )


def start_processes(args, device: torch.device):
    """(rank, world, device, started): under torchrun (RANK and WORLD_SIZE in
    the environment) the process group from the environment, nccl on CUDA
    with this process on card LOCAL_RANK, gloo on the CPU; one process
    otherwise."""
    import torch.distributed as dist

    started = False
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ and not dist.is_initialized():
        if device.type == "cuda":  # nccl's communicator on this card, made now
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
            dist.init_process_group("nccl", init_method="env://", device_id=device)
        else:
            dist.init_process_group("gloo", init_method="env://")
        started = True
    on = dist.is_initialized()
    return (dist.get_rank() if on else 0, dist.get_world_size() if on else 1, device, started)


def make_layout(args, cfg: BagelConfig, world: int, device: torch.device):
    """The mesh layout of the run, or None for one process with no parallel
    flag (the plain path). Refuses JAX's refused combinations."""
    axes = [a for a in (args.context_parallel, args.pipeline_parallel, args.expert_parallel) if a]
    if len(axes) > 1:
        raise ValueError("--context_parallel / --pipeline_parallel / --expert_parallel "
                         "are exclusive")
    if args.expert_parallel and args.sparse_block:
        raise ValueError("--expert_parallel does not support --sparse_block (the ep forward "
                         "routes attention through the dense/chunked paths only; use "
                         "--attn_chunk for long sequences)")
    if args.pipeline_parallel and args.sparse_block:
        raise ValueError("--pipeline_parallel takes the dense-mask or --attn_chunk attention, "
                         "not --sparse_block")
    if world == 1 and not args.mesh and not axes:
        return None
    shape = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else (1, world, 1)
    if len(shape) != 3:
        raise ValueError(f"--mesh takes dp,fsdp,tp, got {args.mesh}")
    mesh = Mesh(shape, device_type=device.type)
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"{a} is not a mesh axis (dp, fsdp, tp)")
    return Layout(mesh, cfg, pipeline_axis=args.pipeline_parallel,
                  expert_axis=args.expert_parallel, context_axis=args.context_parallel)


def frozen_groups(args, params: dict) -> tuple:
    return tuple(name for name, flag in (
        ("llm", args.freeze_llm), ("vit", args.freeze_vit), ("vae", args.freeze_vae),
    ) if flag and name in params)


def _worker_packer(spec: dict, worker_id: int, num_workers: int):
    """Packing-worker factory for MultiprocessLoader (module level so that
    spawn can pickle it): rebuilds the datasets and the packer inside the
    subprocess; finalize stays numpy-only (as_device=False)."""
    from bagel_tpu_torch.data.datasets import DATASET_INFO

    for group, names in spec["dataset_info"].items():
        DATASET_INFO.setdefault(group, {}).update(names)
    datasets, is_mandatory, weights = build_grouped_datasets(
        spec["grouped"], spec["tokenizer"], local_rank=0, world_size=1,
        num_workers=num_workers, worker_id=worker_id, data_status=spec["data_status"],
    )
    return iter(PackedBatchIterator(
        spec["pcfg"], [iter(d) for d in datasets], weights, is_mandatory,
        spec["new_token_ids"], seed=spec["seed"] + worker_id,
        finalize_kwargs={**spec["finalize_kwargs"], "as_device": False}, **spec["sizes"],
    ))


def make_loader(args, cfg: BagelConfig, vae_params, data_status: dict, device):
    """The training batch stream: (PackedTrainBatch on `device`,
    data_indexes) from the grouped datasets of --dataset_config, packed in
    a thread (--num_workers 0) or in spawned worker processes."""
    import yaml

    if args.mock_tokenizer:
        from bagel_tpu_torch.data.tokenizer import MockTokenizer

        tokenizer = MockTokenizer(cfg.llm.vocab_size)
        new_token_ids = tokenizer.new_token_ids
    else:
        from bagel_tpu_torch.data.tokenizer import load_tokenizer

        tokenizer, new_token_ids, _ = load_tokenizer(args.tokenizer_path or args.init_checkpoint)
    with open(args.dataset_config) as f:
        grouped = yaml.safe_load(f)
    pcfg = PackerConfig(
        text_cond_dropout_prob=args.text_cond_dropout_prob,
        vit_cond_dropout_prob=args.vit_cond_dropout_prob,
        vae_cond_dropout_prob=args.vae_cond_dropout_prob,
        vae_image_downsample=cfg.latent_downsample,
        max_latent_size=cfg.max_latent_size,
        vit_patch_size=cfg.vit.patch_size if cfg.vit else 14,
        max_num_patch_per_side=cfg.vit_max_num_patch_per_side,
    )
    sizes = dict(
        expected_num_tokens=args.expected_num_tokens,
        max_num_tokens_per_sample=args.max_num_tokens_per_sample,
        max_num_tokens=args.max_num_tokens,
        prefer_buffer_before=args.prefer_buffer_before,
        max_buffer_size=args.max_buffer_size,
    )
    finalize_kwargs = dict(vit_patch_dim=cfg.vit.patch_dim if cfg.vit else 588,
                           patch_latent_dim=cfg.patch_latent_dim)
    generator = torch.Generator(device=device).manual_seed(args.seed + 77)
    if args.num_workers > 0:
        from bagel_tpu_torch.data.datasets import DATASET_INFO
        from bagel_tpu_torch.data.loader import MultiprocessLoader

        spec = dict(grouped=grouped, tokenizer=tokenizer, data_status=data_status or None,
                    dataset_info=DATASET_INFO, pcfg=pcfg, new_token_ids=new_token_ids,
                    sizes=sizes, seed=args.seed, finalize_kwargs=finalize_kwargs)
        return MultiprocessLoader(functools.partial(_worker_packer, spec), args.num_workers,
                                  vae_params, cfg, generator, device)
    from bagel_tpu_torch.data.loader import PrefetchLoader

    datasets, is_mandatory, weights = build_grouped_datasets(
        grouped, tokenizer, num_workers=1, worker_id=0, data_status=data_status or None)
    packer = PackedBatchIterator(
        pcfg, [iter(d) for d in datasets], weights, is_mandatory, new_token_ids,
        seed=args.seed, finalize_kwargs={**finalize_kwargs, "as_device": False}, **sizes)
    return PrefetchLoader(iter(packer), vae_params, cfg, generator, device)


def main(argv=None):
    import torch.distributed as dist

    args = parse_args(argv)
    rank, world, device, started = start_processes(args, resolve_device(args.device))
    logger = make_logger(rank=rank)
    cfg = build_config(args)
    cuda = device.type == "cuda"
    layout = make_layout(args, cfg, world, device)
    mesh = layout.mesh if layout is not None else None
    par = dict(context_parallel=(mesh, args.context_parallel) if args.context_parallel else None,
               pipeline_parallel=(mesh, args.pipeline_parallel) if args.pipeline_parallel
               else None,
               expert_parallel=(mesh, args.expert_parallel) if args.expert_parallel else None)
    if mesh is not None:
        logger.info(f"mesh {mesh.shape}, {world} processes")

    # --- model ---
    if args.init_checkpoint:
        from bagel_tpu_torch.utils.bridge import params_to
        from bagel_tpu_torch.utils.convert import load_checkpoint_dir

        params = params_to(load_checkpoint_dir(args.init_checkpoint, cfg), device, torch.float32)
        if layout is not None:
            params = shard_params(layout, params)
    else:  # under a mesh every process draws each leaf whole and keeps its shard
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_bagel_params(gen, cfg, dtype=torch.float32, device=device,
                                   place=layout.shard if layout is not None else None)
    frozen = frozen_groups(args, params)
    tx = make_optimizer(
        make_lr_schedule(args.lr, args.warmup_steps, args.total_steps, args.lr_scheduler,
                         args.min_lr),
        args.beta1, args.beta2, args.eps, args.max_grad_norm, frozen=frozen,
    )
    host = "cpu" if cuda else None
    state = init_train_state(params, tx, use_ema=args.ema > 0,
                             opt_device=host if args.optimizer_offload else None,
                             ema_device=host if args.ema_offload else None)

    # --- resume (the reference's precedence, pretrain_unified_navit.py:448-466):
    # an --auto_resume hit is a full resume; --resume_from is the fallback and
    # honours --resume_model_only / --finetune_from_ema
    start_step, data_status = 0, {}
    resume_src, model_only = None, False
    if args.auto_resume:
        resume_src = get_latest_ckpt(args.ckpt_dir)
    if resume_src is None and args.resume_from:
        resume_src, model_only = args.resume_from, args.resume_model_only
    if resume_src and model_only:
        # a model-only resume restarts the step counter: writing into a
        # ckpt_dir with committed steps would collide with them
        if get_latest_ckpt(args.ckpt_dir) is not None:
            raise ValueError(
                f"--resume_model_only starts a fresh step counter but --ckpt_dir "
                f"{args.ckpt_dir} already contains checkpoints; point --ckpt_dir at "
                f"a fresh directory")
        new_params, new_ema = restore_params_only(resume_src, state.params,
                                                  from_ema=args.finetune_from_ema, layout=layout)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(state.params), tree_leaves(new_params)):
                dst.copy_(src)
            if state.ema_params is not None:
                # no EMA in the checkpoint: seed it from the loaded weights
                # (the reference falls back to model.safetensors)
                for dst, src in zip(tree_leaves(state.ema_params),
                                    tree_leaves(new_ema if new_ema is not None else new_params)):
                    dst.copy_(src)
        logger.info(f"loaded {'EMA ' if args.finetune_from_ema else ''}weights from "
                    f"{resume_src} (model only; fresh optimizer/step/data stream)")
    elif resume_src:
        state, saved_status = restore_checkpoint(resume_src, state, layout=layout)
        data_status = data_status_for_process(saved_status, rank)
        start_step = step_from_path(resume_src)
        logger.info(f"resumed from {resume_src} at step {start_step}")

    # --- data: every process packs the same stream, JAX's one process's ---
    vae_params = state.params["vae"] if cfg.visual_gen else None
    loader = make_loader(args, cfg, vae_params, data_status, device)
    data_iter = iter(loader)
    # JAX's rows a micro-step: one packed sequence a dp slice; under the
    # pipeline, the microbatches (replicated over the mesh)
    rows = max(args.pp_microbatches, 2) if args.pipeline_parallel else \
        (mesh.shape["dp"] if mesh is not None else 1)

    meter = ThroughputMeter(cfg.llm, n_chips=world, mot=False)  # each token runs one expert
    noise_gen = torch.Generator(device=device).manual_seed(args.seed + 1000)
    wandb_run = None
    if args.wandb_project and rank == 0:
        try:
            import wandb

            wandb_run = wandb.init(project=args.wandb_project, name=args.wandb_name,
                                   config=vars(args))
        except ImportError:
            logger.info("wandb not installed; skipping")

    loss_kw = dict(ce_weight=args.ce_weight, mse_weight=args.mse_weight,
                   attn_chunk=args.attn_chunk, sparse_block=args.sparse_block, remat=args.remat,
                   **par)
    # --profile_dir traces a 2-step window after the first (warm-up) step
    prof_start = start_step + 1
    prof_stop = min(prof_start + 2, args.total_steps)
    prof = None
    history = []
    seqsq = 0.0
    try:
        for step in range(start_step, args.total_steps):
            if args.profile_dir and step == prof_start:
                prof = profile_trace(args.profile_dir)
                prof.__enter__()
            if prof is not None and step == prof_stop:
                prof.__exit__(None, None, None)
                prof = None
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            grads_acc, metrics, tokens, step_seqsq = None, None, 0, 0.0
            for _ in range(args.gradient_accumulation_steps):
                group = [next(data_iter) for _ in range(rows)]
                bb = stack_batches([b for b, _ in group])
                noise = torch.randn(bb.vae_patches.shape, generator=noise_gen, device=device)
                tokens += bb.position_ids.numel()
                step_seqsq += seqlen_sq(bb.document_id)
                if layout is not None:  # this dp coordinate's rows
                    bb, noise = shard_batch(mesh, bb), shard_batch(mesh, noise)
                try:
                    g, metrics = grad_step(state.params, cfg, bb, noise, layout, **loss_kw)
                except torch.cuda.OutOfMemoryError:
                    # the reference's CUDA-OOM handler (pretrain_unified_navit.py:
                    # 688-693): log the shapes, then re-raise (--auto_resume
                    # restarts from the last checkpoint)
                    logger.error("device OOM at step %d: packed tokens=%s vae_patches=%s "
                                 "accum=%d", step, tuple(bb.position_ids.shape),
                                 tuple(bb.vae_patches.shape), args.gradient_accumulation_steps)
                    raise
                grads_acc = g if grads_acc is None else tree_map(torch.add, grads_acc, g)
                del g
                for _, data_indexes in group:
                    data_status = update_data_status(data_status, data_indexes)
            if args.gradient_accumulation_steps > 1:
                grads_acc = tree_map(lambda x: x / args.gradient_accumulation_steps, grads_acc)
            metrics["grad_norm"] = tx.update_(state.params, grads_acc, state.opt_state, layout)
            del grads_acc
            if state.ema_params is not None:
                ema_update_(state.ema_params, state.params, args.ema)
            state.step += 1
            loss = float(metrics["loss"])  # synchronizes with the device
            record = dict(step=step, loss=loss, seconds=time.perf_counter() - t0, tokens=tokens,
                          grad_norm=float(metrics["grad_norm"]),
                          model_tflop=(meter.dense_c * tokens + meter.attn_c * step_seqsq) / 1e12)
            if cuda:
                record["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
            history.append(record)
            meter.update(tokens)
            seqsq += step_seqsq

            if step % args.log_every == 0:
                meter.seqlen_sq = seqsq
                w = meter.window()
                msg = f"(step={step:07d}) loss: {loss:.4f}, ce: {float(metrics['ce']):.4f}, "
                if "mse" in metrics:
                    msg += f"mse: {float(metrics['mse']):.4f}, "
                msg += f"s/step: {record['seconds']:.3f}, tok/s: {w['tokens_per_sec'] / 1e3:.1f}k"
                if w["mfu"] is not None:
                    msg += f", mfu: {w['mfu'] * 100:.1f}%"
                if "peak_gib" in record:
                    msg += f", peak: {record['peak_gib']:.2f} GiB"
                logger.info(msg)
                if wandb_run is not None:
                    wandb_run.log({k: float(v) for k, v in metrics.items()}
                                  | {"tokens_per_sec": w["tokens_per_sec"]}, step=step)
                meter.reset()
                seqsq = 0.0

            if step > start_step and step % args.save_every == 0:
                # one process: the write runs on a background thread once the
                # state is in host memory; under a mesh the save blocks
                save_checkpoint(args.ckpt_dir, step, state, gather_data_status(data_status),
                                cfg, block=False, layout=layout)
                logger.info(f"checkpoint at step {step}"
                            + (" (async write)" if layout is None else ""))
        if prof is not None:  # total_steps ended inside the trace window
            prof.__exit__(None, None, None)
        save_checkpoint(args.ckpt_dir, args.total_steps, state,
                        gather_data_status(data_status), cfg, layout=layout)
        logger.info("saved final checkpoint")
    finally:
        wait_for_saves()
        if hasattr(loader, "stop"):
            loader.stop()
        if started:
            if world > 1:  # every process leaves after rank 0's final write
                dist.barrier()
            dist.destroy_process_group()
    return state, history


if __name__ == "__main__":
    main()
