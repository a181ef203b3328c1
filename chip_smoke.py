#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bagel_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (the first failure exits non-zero, and no result line is printed):
  1. device  nvidia-smi's name and power limit, torch's device name; TF32 off
             for fp32 matmuls and convolutions (the VAE runs in full fp32).
  2. build   every kernel in bagel_tpu_torch/csrc with nvcc, for sm_90a, one
             nvcc per source, all started together; ptxas registers/spills;
             from `cuobjdump -sass`, B4's dequantization instructions, the
             wgmma (HGMMA) of B3, of B3's two backward kernels (dK/dV, dQ)
             and of B1 at T > 1, the integer wgmma (IGMMA) of B5 and B2,
             and the TMA loads (UTMALDG) of all of them, which must be
             there.
  3. kernels each kernel against its plain PyTorch version: edge cases, then
             the shapes the main paths give it, with its device time (calls
             captured in a CUDA graph, the replay timed with events: no host
             work in it), its call time (back-to-back calls of the wrapper,
             host included), the plain version's, one PyTorch library call's
             device time (a yardstick the port never calls) and the roofline
             bound of the work; and a negative control per kernel that the
             gate must reject.
             3a B1 flash_cached_attention (control: past taken as 0): at
                T > 1 the TMA + wgmma kernel, edge cases with stale NaN
                past the live keys and a strided q; at a decode step (T=1)
                the split-KV pair: edge cases with stale NaN past the live
                keys, two kernels a call (its CUDA graph), and a control
                that drops one live split from the combine; the path shapes
                of text-to-image, VQA and the edit: (a) its VAE-block
                prefill, (b) its ViT-block prefill behind it, (c) its
                denoise over three very unequal pasts; the serving
                runtime's admission of phase 9's chats as its plan gives it
                (the 8-row image round, the plain version one live row at
                a time, and the 8-row text round) and a speculative verify
                (B=8, T=5 over ragged slot pasts); B1-kv8
                (flash_decode_kv8, the decode pair over an int8 KV cache)
                against kv_dequantize + the plain attention: edge cases and
                the 8-slot serving shape (ragged pasts 50-4975 of an
                8192-slot cache), NaN scales and random codes past every
                live end, bit-identical to the bf16 pair at B1-kv8's splits
                (kv8_splits) on the dequantized view (control: one row's
                scales taken as 1), timed against its bytes bound and
                against B1's bf16 pair over the same live keys;
             3b B3 sparse_packed_attention (control: two packed images merged
                into one segment; the full-tile flags timed against the same
                launch without them; the SigLIP shape timed against SDPA in
                turns);
             3c B5 int8_matmul on k-major weights (utils.quant.to_kmajor),
                bit for bit at the w8a8 text-to-image shapes, M=1 and a
                ragged M/N/K (control: ws reversed); the activation
                quantization pass (quantize_rows) bit for bit, codes and
                scales, at the four path shapes and a ragged one, timed
                against its bytes bound; a row split over tp (o and down at
                tp = 2 and 4's local K, M in {1, 8, 77}): the reduce-only
                pass (row_absmax) and the given-scale one
                (quantize_rows_given) bit for bit (control: a scale 1 %
                off), B5's f32 instance bit for bit against the plain
                epilogue before its rounding, each timed at tp = 2 against
                its bound;
             3d B4 int4_matmul at every decode linear's shape, M in {1, 3, 64},
                one launch a call (the counter, and the kernel nodes of one
                call captured in a CUDA graph), two calls bit-identical,
                the fused bias as JAX rounds it (control: the nibbles
                swapped); one decode token's 112 launches over 28 layers'
                own weights, cold in L2, against torch.matmul over 28
                layers' bf16 weights;
             3e B2 flash_cached_attention_q8 at its key tile (128), at the
                denoise and ViT-block shapes (control: V's scale left out),
                on the codes of its prep pass q8_prep (two kernels), which
                is held bit for bit against its plain version (codes, V^T
                layout, scales) and timed against its bytes bound.
  4. forward one full-width MoT gen-block forward (512 px, full depth)
             through the kernel and through the dense path: velocity rel.
             error; the full-width SigLIP tower on a 980 px image through
             encode_vit_tokens, kernel vs dense, at 1 and 27 layers.
  5. t2i     text-to-image through BagelEngine.__call__ at full width and depth
             (BAGEL-7B-MoT + SigLIP so400m shapes, seeded random bf16
             weights), 1024 px, 8 timesteps; B1's launch count must be
             L x (2 + 7).
  6. vqa     image understanding through BagelEngine.__call__ on the same
             weights: a seeded 980 px image and a question, 32 greedy decode
             tokens at most, decoded through the engine's decode program
             (CUDA graphs of 16 steps); B3 launches once per SigLIP layer
             (27), B1 L x (2 prefills + the capture's warm-up step + decode
             steps), the decode steps in the program's whole chunks and
             launched by its replays, which are counted from the graph's
             kernel nodes (L x decode steps of them); the first decode
             step's logits through the kernels vs the dense path; the
             pieces' times.
  6a. taylorseer  phase 5's image with every step full (first_enhance 7):
             its latent equal to phase 5's; a 50-timestep 1024 px __call__
             with the default step cache, B1 L x (2 + 19), against the same
             image without it, L x (2 + 49); seconds and peak memory of both.
  6b. edit   the VQA image (vae_transform ImageTransform(1024, 512, 16): 976
             px) and an instruction through __call__ on a second engine over
             the same weights with a 16384-slot KV buffer: a 976 px image,
             B1 L x (4 prefills + 7 forwards), B3 27; the three contexts and
             one gen block's velocity through the kernels vs the plain path
             (1 and 28 layers); vae_encode on the card vs the CPU; the
             pieces' times and peak memory.
  6c. batch  generate_batch of two prompts at 1024 px, 8 timesteps: B1
             L x (2 + 7); each job's latent at J=2 vs alone; seconds per
             image batched against phase 5's.
  7. w8a8    the weights quantized to w8a8, fused and made k-major
             (utils.quant.w8a8_kmajor), text-to-image through __call__ with
             BAGEL_FLASH_INT8=1: B5 L x (4 x 2 + 8 x 7) and as many
             quantization passes, B2 L x (2 + 7) and as many q8_prep
             passes, no B1; peak memory at most
             W8A8_PEAK_GIB; a gen-block velocity through the kernels vs
             the plain versions (and, as a control, the plain path at another
             key tile), w8a8 vs bf16; seconds per image and peak memory.
  8. int4    the weights quantized to int4 and fused, the VQA of phase 6
             through __call__: B4 L x 4 x (the warm-up step + decode steps)
             (whole chunks, as in 6; B4 captured in the decode program's
             graphs and its replays counted from their nodes), B1 and B3 as
             in 6; the
             first decode step's logits through the kernels vs the plain
             versions; ms per decode token.
  9. serve   the serving path on phase 5's weights: a ServingRuntime (8
             slots of an 8192-slot cache, 16-step decode chunks) behind the
             HTTP server (serve_in_thread on 127.0.0.1, an ephemeral port),
             driven by urllib from client threads: (a) 8 chats (2 on the
             VQA image as PNG, 6 text-only of 20-200 prompt tokens, 32
             tokens each), a streaming chat and a 1024 px generate at once,
             B1 L x (prefill blocks + decode forwards + the decode
             program's warm-up steps, one a capture + 2 + 7), B3 LV x the
             runtime's packed SigLIP passes (all runs); (b) the 8 chats on
             a second engine over the same parameter tensors with
             kv_quant=True: B1 L x prefill blocks (none at T = 1), B1-kv8 L
             x (decode steps + warm-up steps); (c) the 8 chats with
             speculative=4: B1 L x (prefill blocks + verify forwards +
             warm-up verifies); the replays' launches counted from the
             graphs' kernel nodes. Every reply 200, /v1/stats
             exact; the first decode step's and a T = 5 verify block's
             logits of an 8-row slot cache prefilled as the runtime does,
             kernels vs plain over a bf16 and an int8 cache, int8 vs bf16
             (control: one row's scales taken as 1); each answer against
             the request alone (reported);
             tokens/s at 8 slots against one; latencies; cache GiB.
  9d. decode program  the decode program (CUDA graphs of decode chunks)
             against the eager loop (graph=False: the same steps without a
             graph) on phase 9's weights: greedy tokens identical for
             gen_text (one row, 32 tokens) and for the 8-slot runtime over a
             bf16 cache, an int8 cache, with speculative=4 and with int8 and
             speculative=4 (captures and chunk times); an 8-row slot
             cache decoded 20 steps in 16-step chunks with one row frozen:
             tokens and lengths identical (control: a program whose 4th
             step attends with the frozen row's q_valid on must fail); no
             replay syncs with the host (set_sync_debug_mode("error")); ms
             a token at one row and a step at 8 slots, eager and program
             (and the program captured without keep, its put-back's cost),
             tokens/s at 8 slots, capture seconds and graph pool GiB, the
             card's idle share over a 16-step decode (torch.profiler).
  9e. eval  the eval runners (bagel_tpu_torch.eval) on phase 9's weights:
             (a) gen_runner.run_gen with the JAX runner's defaults at 8
             timesteps: 3 text rows over phase 5's engine, each timed
             (median and spread), B1 L x (2 + 7) a row, and an edit row on
             a seeded 976 px PNG over an engine like 6b's, B1 L x (4 + 7)
             and B3 27; each PNG within one level of a direct __call__
             with a generator seeded seed + index; a second run writes
             nothing and launches nothing; (b) vlm_runner.run_eval on 8
             seeded 980 px PNGs with yes/no questions: 3 rows alone, one
             by one, each answer equal to a direct __call__ (B3 27 and B1
             as in 6 a row), then all 8 batched through chat_batch (B3 27,
             B1 L x (2 + warm-up steps + decode steps)), each answer
             against its row alone (reported), the first decode step's
             logits of each batched row within LOGITS_TOL of its row
             alone, score_yesno written; (c) judge_scorer wise over (a)'s layout through the
             HTTP judge against a mock endpoint on 127.0.0.1: the summary
             its fixed reply implies; (d) gen_runner.main and
             vlm_runner.main with no --device (so CUDA) on the demo
             weights (serving.app.demo_config): the layout written, B1
             launched; seconds per eval image and per answer, alone and
             batched, and the phase's wall time.
 10. train   training at full width and TRAIN_LAYERS of 28 LLM layers (fp32
             state does not fit deeper; the phase frees phase 9's model
             first): (a) B3's gradient (sparse_packed_attention_train: the
             kernel forward with its logsumexp, then the backward kernels
             of csrc/sparse_packed_attention_bwd.cu) at S=2048 on the
             training predicate (three documents, full and noise splits,
             padding), H/KH/D 28/4/128 and 16/16/72: one launch of each,
             the forward bit-identical with and without lse stored, lse
             against the plain one, dq/dk/dv within B3's gate of the plain
             version's autograd and of the kernels' plain twin fed the
             kernel's lse, stale NaN in padding rows changes nothing,
             controls: the noise predicate dropped, lse shifted by 1;
             (b) B3 at the LLM's training shape on a packed batch's ids
             (the packer, TRAIN_TOKENS a step): the forward against the
             chunked plain version, its device time, its operations bound
             over the visible pairs, SDPA with the boolean mask in turns;
             then the backward kernels there and at the SigLIP tower's
             packed length in the same batch (H 16, D 72): against the
             chunked recompute's VJP (norm-relative gated, the elementwise
             tail reported), device and call time, each kernel's device
             µs, the bound (10 D H pairs), the plain twin's and the
             recompute's time, SDPA's backward under autograd in turns
             (at the full length, or its half if that does not fit), peak
             memory; (c) a
             parquet corpus of seeded images (text-to-image rows and edit
             chains, an edit chain in every sequence) through the driver's
             loader (VAE encode on the card): the model gate,
             --sparse_block vs --attn_chunk 512 on one batch and the same
             weights (loss within TRAIN_LOSS_TOL, each top-level group's
             gradient within TRAIN_GRAD_TOL; control: the samples merged
             into one document), B3 2 x TRAIN_LAYERS + 27 launches a step
             and its backward TRAIN_LAYERS + 27, a falling
             loss over TRAIN_STEPS steps on that batch, then driver.main
             timed over TRAIN_STEPS steps (s/step, tokens/s, MFU at 989
             TFLOP/s, peak GiB) and a checkpoint run (saves at steps 2 and
             3, the LLM and SigLIP frozen, no EMA: two full saves would not
             fit this machine's disk) whose --auto_resume restores every
             parameter bit for bit.
 11. parallel  the trainer in child processes (`chip_smoke.py --child
             SPEC`) under torchrun's environment, from live weights (the
             driver's init with `live_place`), saving no checkpoint: (a)
             through nccl at world 1: --mesh 1,1,1 --sparse_block 128 at
             phase 10's packing (B3 and its backward counted),
             --pipeline_parallel fsdp (two TRAIN11_TOKENS rows a step) and
             --context_parallel fsdp (the ring's block in 512-row query
             chunks), each gated at its first micro-step against the plain
             path on the same weights and batch (the loss and each group's
             gradient; a control with no attention on a quarter of the
             rows must fail the gate), s/step, tokens/s, peak; (b) two
             serving processes on the card over a gloo bus
             (serving.multihost), 8 greedy chats twice: the leader's
             answers equal a runtime alone's, the follower's the leader's,
             equal ticks; the bus's ms a tick, tokens/s in the chunks, peak
             a process; (c) on two cards or more (a line says when there
             are fewer): ep = 2 and fsdp over every card, each gated
             against one process's plain path on the whole tree, and fsdp
             at 28 layers with offload.
 12. sharded  sharded inference (`parallel.mesh.InferenceLayout`): (a) this
             process alone in an nccl group, mesh 1,1,1 (nothing splits;
             every tp and dp collective launches, in the decode programs'
             graphs too), on phase 5's weights: phase 5's image and latent
             and phase 6's VQA answer bit for bit through the sharded
             engine, the 8-slot runtime over a bf16 and an int8 cache and
             with speculative=4, each answer equal to the plain runtime's
             on the same queue, launch counts and the collectives issued
             (eager and captured) against their formulas, the 8-slot
             chunk's time beside the plain engine's; (b) tp = 2 in two
             processes on the one card over gloo (`--child`; NCCL takes
             one rank a device), each building its half of live_place
             weights in turns, eager: a full-depth gen block's velocity,
             the first decode step's logits and a greedy VQA answer
             against one process's engine on the same weights, a control
             (one rank's o partial sums dropped) that must fail the gate;
             B4 launched at the local shard shapes in int4 decode steps
             (eligible on the whole leaf's width) and against its plain
             version there, B5 in a w8a8 gen block and bit for bit at the
             local shapes, that gen block's velocity against one
             process's w8a8 (each row-parallel row quantized with its
             whole row's scale; the row-parallel weights quantized on the
             whole leaf, as a w8a8 checkpoint arrives) after one layer
             and after all, with a control (each rank's own scale) that
             must fail the one-layer gate, its launches and all-reduces
             by formula;
             (c) tp over two cards or more through nccl (a
             line says when the machine has fewer).
Then one JSON line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

int4_split_sweep() times B4 at every split of K it takes,
decode_split_sweep() B1's decode pair at several numbers of splits, and
kv8_split_sweep() B1-kv8 at several numbers of splits (not run by the smoke;
their docstrings say how to run them).
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import random
import re
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
SEED = 0
PROMPT = "A photo of a red fox sitting in fresh snow at sunrise, highly detailed"
QUESTION = "What is shown in this picture? Describe the main object and its colour."
PX = 1024
VQA_PX = 980  # SigLIP so400m's image size: a 70 x 70 patch grid
MAX_THINK = 32  # decode tokens at most
FORWARD_PX = 512
NUM_TIMESTEPS = 8  # timestep_shift 3: 6 steps with CFG (3 branches), 1 without
CFG = dict(cfg_text_scale=4.0, cfg_img_scale=1.5, timestep_shift=3.0,
           num_timesteps=NUM_TIMESTEPS)
MAX_KV = 8192
# the edit: the VQA image through the engine's vae_transform (980 px crops to
# 976 for the stride of 16: a 61 x 61 latent grid, and 966 for the ViT: 69 x
# 69 patches) and a 55-character instruction; the cond context then holds
# ~8.5k keys before its 3723-token gen block, past an 8192-slot buffer
EDIT = "Make the fox bright blue and add snowflakes in the sky."
EDIT_TRANSFORM = (1024, 512, 16)  # ImageTransform(max, min, stride)
EDIT_MAX_KV = 16384
TS_TIMESTEPS = 50  # the TaylorSeer image: the default schedule's 19 full forwards of 49
BATCH_PROMPTS = (PROMPT, "A watercolor painting of a lighthouse on a cliff above a stormy sea")
# phase 9, serving: 8 slots of an 8192-slot cache, 16-step decode chunks, 32
# tokens an answer; six text chats of ~20 to ~200 prompt tokens
# (MockTokenizer: a token a character) and two on the VQA image
SERVE_SLOTS = 8
SERVE_CHUNK = 16
SERVE_TOKENS = 32
SERVE_SPECULATIVE = 4
SERVE_PROMPT_CHARS = (20, 45, 80, 120, 160, 200)
SERVE_GATE_PX = 392  # the model gate's images: the plain path's scores fit the card
SLOT_PASTS = [50, 4975, 1200, 3000, 63, 64, 2047, 700]  # B1-kv8's slot decode shape
KERNELS = ("flash_cached_attention", "sparse_packed_attention", "sparse_packed_attention_bwd",
           "int8_matmul", "int4_matmul", "flash_cached_attention_q8")
# kernel vs plain, both bf16 out, over the valid rows of each batch row:
#   elementwise |kernel - plain| <= KERNEL_RTOL |plain| + KERNEL_ATOL_RMS rms(plain)
#   and ||kernel - plain|| / ||plain|| <= KERNEL_REL.
# One bf16 ulp is 2^-8..2^-7 of a value, and the two round P and the output
# at different points (P unnormalized vs normalized): 2^-6 is 2-4 ulp. The
# rms term covers outputs near 0, where a relative limit is empty: over
# ~4170 keys a typical output is ~0.026, so the limit there is ~2.6e-3.
KERNEL_RTOL = 2.0 ** -6
KERNEL_ATOL_RMS = 0.1
KERNEL_REL = 1e-2
KERNEL_TOL = (f"|err| <= {KERNEL_RTOL} |plain| + {KERNEL_ATOL_RMS} rms(plain), "
              f"||err|| / ||plain|| <= {KERNEL_REL}, per batch row")
FORWARD_TOL_1 = 1e-2  # velocity rel. error after one layer (bf16 attention rounding)
FORWARD_TOL = 5e-2  # after 28 random-weight layers, which amplify it
# the ViT tower's output, kernel vs dense: one layer leaves one attention's
# bf16 rounding (~3e-3 relative) diluted by the residual stream; 27
# random-weight layers may amplify it as the LLM's 28 did (PR 1: 5.7e-3 at
# 1 layer, 3.2e-2 at 28), so the same two limits
VIT_TOL_1 = 1e-2
VIT_TOL = 5e-2
# the first decode step's logits, kernel path (B3 x 27, B1 x 28 x 3) vs dense:
# the ViT's error feeds 28 LLM layers, each adding its own attention
# rounding; twice the velocity's limit for the longer chain
LOGITS_TOL = 1e-1
# the first decode step's logits over an int8 slot cache vs a bf16 one (both
# through the kernels): measured 5.1e-2 on this seed (NVIDIA H100 80GB HBM3,
# 700 W); the limit is twice that reading, and the control that reads one
# row's codes unscaled (its scales taken as 1) must land above it
INT8_KV_LOGITS_TOL = 1e-1
# the w8a8 image's peak memory: the 47.75 GiB that the row-major design
# reached (NVIDIA H100 80GB HBM3) plus 0.5 GiB; the k-major weights are made
# before the image, one leaf at a time
W8A8_PEAK_GIB = 47.75 + 0.5
PEAK_FLOPS = 989e12  # H100 SXM bf16 dense
PEAK_INT8 = 1979e12  # H100 SXM int8 dense (operations per second)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean time of one call of fn() over `iters` back-to-back calls, between
    two events on the stream: the "call" time. Where a call's device work
    is shorter than the host's work to issue it (checks, allocation, the
    launch), this is host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call of fn(): `iters` calls captured in one
    CUDA graph, whose replay is timed between two events, so that none of
    the host's work per call is in it. fn must not synchronize with the
    host. Launch counters count the captured calls once, at capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture wants
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Mean host time of one call of fn(), in µs, over `iters` calls issued
    back to back (no synchronization inside the window)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def sass_counts(name: str, opcodes) -> dict:
    """{kernel function: {opcode: count}} in the built library's SASS
    (`cuobjdump -sass`), counting each instruction whose opcode starts with
    one of `opcodes` (a static count: an unrolled loop counts once)."""
    from bagel_tpu_torch.ops import _build

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    run = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                         capture_output=True, text=True, timeout=120)
    check(run.returncode == 0, f"cuobjdump -sass {name} failed: {run.stderr.strip()[:400]}")
    counts, fn = {}, None
    for line in run.stdout.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = {op: 0 for op in opcodes}
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if ins and fn is not None:
            for op in opcodes:
                if ins.group(1) == op or ins.group(1).startswith(op + "."):
                    counts[fn][op] += 1
    return counts


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_device() -> tuple:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    name = torch.cuda.get_device_name(0)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] nvidia-smi: {card}")
    log(f"[device] torch: {name}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return name, card


def phase_build() -> None:
    from bagel_tpu_torch.ops import _build

    check(sorted(KERNELS) == _build.kernel_names(),
          f"KERNELS {KERNELS} != the sources in csrc {_build.kernel_names()}")
    cached = [name for name in KERNELS if _build.library_path(name).is_file()]
    t0 = time.perf_counter()
    reports = _build.build_all(KERNELS)
    log(f"[build] {', '.join(KERNELS)} built in {time.perf_counter() - t0:.1f} s "
        f"(one nvcc per source, in parallel)")
    for name in KERNELS:
        if name in cached:
            kept = "ptxas report as kept beside it" if reports[name] else "no ptxas report kept"
            log(f"[build] {name}: cached at {_build.library_path(name)}; {kept}")
        instance = ""
        for line in reports[name].splitlines():
            if "Compiling entry function" in line:
                d = re.search(r"ILi(\d+)E", line)  # an int template argument
                arg = "rows" if name == "int4_matmul" else "D"  # B4's rows per block
                instance = f" ({arg}={d.group(1)})" if d else ""
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}{instance}: {line.strip()}")
    # what the redesigned kernels compiled to: B4's dequantization
    # instructions, and the Hopper tensor-core and TMA instructions of the
    # others; the Hopper designs are the ones that run: wgmma (HGMMA) or
    # integer wgmma (IGMMA), and TMA loads (UTMALDG), in each kernel function
    # named here
    required = {
        "sparse_packed_attention": (("sparse_packed_attention_kernel",), ("HGMMA", "UTMALDG"),
                                    "B3"),
        "sparse_packed_attention_bwd": (("sparse_bwd_dkdv_kernel", "sparse_bwd_dq_kernel"),
                                        ("HGMMA", "UTMALDG"), "B3's backward"),
        "int8_matmul": (("int8_matmul_kernel",), ("IGMMA", "UTMALDG"), "B5"),
        "flash_cached_attention": (("flash_cached_attention_kernel",), ("HGMMA", "UTMALDG"),
                                   "B1 at T > 1"),
        "flash_cached_attention_q8": (("flash_q8_kernel",), ("IGMMA", "UTMALDG"), "B2"),
    }
    for name, ops in (("int4_matmul", ("I2F", "I2FP", "F2F", "F2FP", "PRMT", "LOP3", "FFMA",
                                       "FMUL", "FADD", "LDG")),
                      ("sparse_packed_attention", ("HGMMA", "UTMALDG", "HMMA", "LDGSTS",
                                                   "MUFU")),
                      ("sparse_packed_attention_bwd", ("HGMMA", "UTMALDG", "HMMA", "LDGSTS",
                                                       "MUFU")),
                      ("int8_matmul", ("IGMMA", "HGMMA", "UTMALDG", "IMMA", "LDGSTS")),
                      ("flash_cached_attention", ("HGMMA", "UTMALDG", "HMMA", "LDGSTS", "MUFU")),
                      ("flash_cached_attention_q8", ("IGMMA", "UTMALDG", "IMMA", "MUFU", "I2F",
                                                     "F2I", "IDP", "PRMT"))):
        pieces, need, label = required.get(name, ((), (), ""))
        found = set()
        for fn, counts in sass_counts(name, ops).items():
            log(f"[build] {name} SASS {fn}: {json.dumps(counts)}")
            for piece in pieces:
                if piece in fn:
                    check(all(counts[op] > 0 for op in need),
                          f"{label}'s SASS ({fn}) lacks one of {need}: {json.dumps(counts)}")
                    log(f"[build] {label} SASS: {' and '.join(need)} present in {fn}")
                    found.add(piece)
        check(found == set(pieces), f"no function {set(pieces) - found} in {name}'s SASS")


# ---------------------------------------------------------------------------
# phase 3a: B1 flash_cached_attention against its plain version
# ---------------------------------------------------------------------------


def attention_work(past, valid, t, h, kh, d, causal):
    """(FLOPs, bytes) the function needs on these inputs: two products over
    the visible (query, key) pairs; q and out once, the live K/V once."""
    pairs = 0
    for p, n in zip(past, valid):
        n = min(n, t)
        pairs += n * p + (n * (n + 1) // 2 if causal else n * n)
    flops = 4 * d * h * pairs
    bytes_ = 2 * (2 * len(past) * t * h * d + 2 * sum(p + min(n, t) for p, n in zip(past, valid)) * kh * d)
    return flops, bytes_


def bound_ms_at(ops, bytes_, peak):
    """The least time for `ops` operations at `peak` per second and `bytes_`
    at the memory rate: (ms, what bounds it)."""
    t_ops, t_bytes = ops / peak * 1e3, bytes_ / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_ms(flops, bytes_):
    return bound_ms_at(flops, bytes_, PEAK_FLOPS)


def attention_inputs(gen, b, t, s, h, kh, past, valid, garbage=None):
    dev = DEVICE
    q = torch.randn((b, t, h, 128), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, kh, 128), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, kh, 128), generator=gen, device=dev).bfloat16()
    if garbage is not None:  # stale values beyond each row's live region
        for row, (p, n) in enumerate(zip(past, valid)):
            k[row, p + n:] = garbage
            v[row, p + n:] = garbage
    return (q, k, v, torch.tensor(past, dtype=torch.int32, device=dev),
            torch.tensor(valid, dtype=torch.int32, device=dev))


def kernel_error(got, want, valid):
    """(max abs error, worst elementwise error in units of its limit, worst
    norm-relative error) over the valid rows of each batch row."""
    err = ratio = rel = 0.0
    for row, n in enumerate(valid):
        n = min(n, got.shape[1])
        if n:
            g, w = got[row, :n].float(), want[row, :n].float()
            d = (g - w).abs()
            limit = KERNEL_RTOL * w.abs() + KERNEL_ATOL_RMS * w.pow(2).mean().sqrt()
            err = max(err, d.max().item())
            ratio = max(ratio, (d / limit.clamp(min=1e-30)).max().item())
            rel = max(rel, (d.norm() / w.norm().clamp(min=1e-30)).item())
    return err, ratio, rel


def within_tol(ratio, rel):
    return ratio <= 1.0 and rel <= KERNEL_REL


def plain_rows(flash, args, causal):
    """The plain version one live row at a time (rows with valid = 0 give
    0): its fp32 scores of a long block at B = 8 would not fit the card."""
    q, k, v, past, valid = args
    out = torch.zeros_like(q)
    for row in torch.nonzero(valid).flatten().tolist():
        r = slice(row, row + 1)
        out[r] = flash.flash_cached_attention_plain(q[r], k[r], v[r], past[r], valid[r],
                                                    causal=causal)
    return out


def compare(flash, args, causal, label, rowwise=False):
    q, k, v, past, valid = args
    got = flash.flash_cached_attention(q, k, v, past, valid, causal=causal)
    want = (plain_rows(flash, args, causal) if rowwise else
            flash.flash_cached_attention_plain(q, k, v, past, valid, causal=causal))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite kernel output")
    for row, n in enumerate(valid.tolist()):
        pad = got[row, min(n, q.shape[1]):]
        check(pad.numel() == 0 or pad.abs().max().item() == 0.0,
              f"{label}: padded rows are not exactly 0")
    err, ratio, rel = kernel_error(got, want, valid.tolist())
    check(within_tol(ratio, rel),
          f"{label}: kernel vs plain max abs {err:.3e} ({ratio:.2f} x the elementwise "
          f"limit), rel {rel:.3e} (limit {KERNEL_REL})")
    return got, want, err, ratio, rel


def relative_error(got, want):
    """||got - want|| / ||want|| in fp32 (rows past valid are 0 in both)."""
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def sdpa_call(q, k, v, mask):
    """One PyTorch call computing the same function (a yardstick only; the
    port never calls it)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def cache_mask(s, t, past, valid, causal):
    """The attention's boolean mask over an s-slot cache, for SDPA."""
    from bagel_tpu_torch.ops.attention import cache_block_mask

    return cache_block_mask(s, t, past, valid, causal)[:, None]


def short_name(mangled: str) -> str:
    """A kernel's name out of its mangled symbol (a name is mangled as its
    length, then itself), for the log."""
    for i in range(len(mangled)):
        digits = re.match(r"\d+", mangled[i:])
        if digits:
            name = mangled[i + digits.end() : i + digits.end() + int(digits.group())]
            if name.endswith("kernel"):
                return name
    return mangled[:60]


def decode_checks(flash, args, want, valid, label):
    """B1 at a decode step: one call runs two kernels on the card (the split
    kernel, then the combine: the kernel nodes of one call captured in a
    CUDA graph), and the gate rejects the combine of the
    kernel's own splits with one live split left out. Returns the splits
    and each kernel's device µs a call (torch.profiler)."""
    from bagel_tpu_torch.utils.cuda_graph import kernels_on_card

    q, k, v, p, vl = args
    names = kernels_on_card(lambda: flash.flash_cached_attention(q, k, v, p, vl, causal=True))
    check(len(names) == 2 and "split" in names[0] and "combine" in names[1],
          f"{label}: one decode call ran {names} on the card, not the split and combine kernels")
    splits = flash.decode_splits(q.shape[0], k.shape[2], q.device)
    m, l, acc = flash.decode_partials_plain(q, k, v, p, vl, splits)
    live = torch.nonzero(~torch.isinf(m[0, 0])).flatten()
    gone = int(live[len(live) // 2])
    m[..., gone], l[..., gone] = float("-inf"), 0.0
    blind = flash.decode_combine_plain(m, l, acc, q.dtype)
    b_err, b_ratio, b_rel = kernel_error(blind, want, valid)
    check(not within_tol(b_ratio, b_rel),
          f"{label}: the gate accepts a combine that drops live split {gone}")
    kernel_us = kernel_device_us(lambda: flash.flash_cached_attention(q, k, v, p, vl, causal=True))
    log(f"[kernels] {label}: one call ran two kernels on the card (its CUDA graph): "
        f"{short_name(names[0])}, {short_name(names[1])}; their device µs a call "
        f"{json.dumps(kernel_us)}; "
        f"{splits} splits a KV head, {len(live)} live; control that drops live split {gone} "
        f"from the combine is rejected: max abs {b_err:.3e} ({b_ratio:.1f} x the elementwise "
        f"limit), rel {b_rel:.3e}")
    return splits, kernel_us


def phase_kernels(cfg, prompt_len, prefill_t, vqa, edit, serve):
    from bagel_tpu_torch.ops import flash

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    worst = 0.0
    edge = [
        # label, b, t, s, h, kh, past, valid, garbage
        ("past=0", 1, 64, 256, 4, 4, [0], [64], None),
        ("valid<T, T=100 ragged, mixed past", 2, 100, 256, 4, 2, [0, 30], [77, 100], None),
        ("GQA 28/4, batch of mixed past", 3, 130, 512, 28, 4, [37, 0, 150], [130, 130, 97], None),
        ("T=1 block", 2, 1, 256, 28, 4, [100, 0], [1, 1], None),
        ("a row with valid=0", 2, 16, 128, 4, 4, [10, 0], [16, 0], None),
        ("stale garbage beyond the live region", 2, 70, 256, 8, 4, [20, 5], [70, 40], 3.0e4),
        ("strided q (a fused projection's view), a causal diagonal at past > 0, a partial "
         "last live tile", 2, 300, 1024, 28, 4, [200, 37], [300, 250], 3.0e4),
        # a decode step (T=1) takes the split-KV pair: ~33 splits a KV head
        ("decode past=0", 1, 1, 256, 28, 4, [0], [1], 3.0e4),
        ("decode, a tile boundary at past + 1", 1, 1, 1024, 28, 4, [255], [1], 3.0e4),
        ("decode, more splits than live tiles", 1, 1, 1024, 28, 4, [70], [1], 3.0e4),
        ("decode, B=3 of mixed past, a q_valid=0 row", 3, 1, MAX_KV, 28, 4, [37, 4000, 1200],
         [1, 0, 1], 3.0e4),
    ]
    for label, b, t, s, h, kh, past, valid, garbage in edge:
        for causal in (True, False):
            args = attention_inputs(gen, b, t, s, h, kh, past, valid, garbage)
            if label.startswith("strided q"):  # rows of a wider [B, T, H D + 2 KH D] tensor
                wide = torch.zeros((b, t, (h + 2 * kh) * 128), dtype=torch.bfloat16,
                                   device=DEVICE)
                wide[..., : h * 128] = args[0].reshape(b, t, h * 128)
                args = (wide[..., : h * 128].view(b, t, h, 128), *args[1:])
            name = f"{label}, {'causal' if causal else 'non-causal'}"
            got, _, err, ratio, rel = compare(flash, args, causal, name)
            if garbage is not None:  # NaN beyond the live region changes nothing
                q, k, v, p, n = args
                for row, (pp, nn) in enumerate(zip(past, valid)):
                    k[row, pp + nn:] = float("nan")
                    v[row, pp + nn:] = float("nan")
                again = flash.flash_cached_attention(q, k, v, p, n, causal=causal)
                check(torch.equal(again, got), f"{name}: stale NaN leaked into the output")
            worst = max(worst, err)
            log(f"[kernels] edge {name}: max abs err {err:.3e} ({ratio:.2f} x the elementwise "
                f"limit), rel err {rel:.3e}")

    # the shapes the main paths give the kernel (28 heads over 4 KV heads,
    # D=128, an 8192-slot cache): 1024 px denoise with CFG (3 rows, the
    # cfg_text row has an empty cache), without CFG, and the prompt prefill;
    # the VQA image block, the question after it and one decode step; an
    # edit's VAE block and ViT block (prefills into a 16384-slot cache) and
    # its denoise with CFG, whose buffer is the live prefix (a gen block's
    # forward reads cache.k[:, :max(past) + T]); the serving runtime's
    # admission of phase 9's eight chats into its 8-slot cache, as its plan
    # gives them (one image round: the two 980 px images, six rows at
    # valid 0; the ragged text round after it), and a speculative verify
    # (T = K + 1) over ragged slot pasts
    n = (PX // cfg.latent_downsample) ** 2 + 2
    e_a, e_vit, e_vit_t, e_q = edit["vae_t"], edit["vit_valid"], edit["vit_t"], edit["q_len"]
    e_past = [e_a + e_vit + e_q, e_a + e_vit, e_q]
    s_img, s_text = serve["image_valid"], serve["text_valid"]
    shapes = [
        ("denoise B=3 (CFG)", 3, n, MAX_KV, [prompt_len, 0, prompt_len], [n] * 3, False),
        ("denoise B=1", 1, n, MAX_KV, [prompt_len], [n], False),
        ("prefill", 1, prefill_t, MAX_KV, [0], [prompt_len], True),
        ("vit-block prefill", 1, vqa["vit_t"], MAX_KV, [0], [vqa["vit_valid"]], False),
        ("question prefill", 1, vqa["q_t"], MAX_KV, [vqa["vit_valid"]], [vqa["q_len"]], True),
        ("decode T=1", 1, 1, MAX_KV, [vqa["vit_valid"] + vqa["q_len"]], [1], True),
        ("edit (a) vae-block prefill", 1, e_a, EDIT_MAX_KV, [0], [e_a], False),
        ("edit (b) vit-block prefill", 1, e_vit_t, EDIT_MAX_KV, [e_a], [e_vit], False),
        ("edit (c) denoise B=3 (CFG)", 3, e_a, max(e_past) + e_a, e_past, [e_a] * 3, False),
        ("serve image round B=8", SERVE_SLOTS, serve["image_t"], MAX_KV, [0] * SERVE_SLOTS,
         s_img, False),
        ("serve text round B=8", SERVE_SLOTS, serve["text_t"], MAX_KV, s_img, s_text, True),
        ("serve verify B=8", SERVE_SLOTS, SERVE_SPECULATIVE + 1, MAX_KV, SLOT_PASTS,
         [SERVE_SPECULATIVE + 1] * SERVE_SLOTS, True),
    ]
    results = []
    for label, b, t, s_len, past, valid, causal in shapes:
        args = attention_inputs(gen, b, t, s_len, 28, 4, past, valid)
        # where the fp32 scores of all rows at once would pass 16 GiB (the
        # serve image round: 34 GiB), the plain version and SDPA take the
        # live rows one at a time
        rowwise = b * 28 * t * s_len * 4 > 16 * 2**30
        got, want, err, ratio, rel = compare(flash, args, causal, label, rowwise)
        worst = max(worst, err)
        q, k, v, p, vl = args

        def plain(past_len):
            a = (q, k, v, past_len, vl)
            return (plain_rows(flash, a, causal) if rowwise else
                    flash.flash_cached_attention_plain(*a, causal=causal))

        if any(past):  # negative control: the gate rejects a plausible wrong kernel
            blind = plain(torch.zeros_like(p))
            b_err, b_ratio, b_rel = kernel_error(blind, want, valid)
            check(not within_tol(b_ratio, b_rel),
                  f"{label}: the gate accepts an attention that takes past as 0")
            log(f"[kernels] {label}: control that takes past as 0 is rejected: "
                f"max abs {b_err:.3e} ({b_ratio:.1f} x the elementwise limit), rel {b_rel:.3e}")
            del blind
        splits, kernel_us = decode_checks(flash, args, want, valid, label) if t == 1 else (None,
                                                                                        None)
        del got, want
        def call():
            return flash.flash_cached_attention(q, k, v, p, vl, causal=causal)

        ms, call_ms = device_ms(call, 20), cuda_ms(call, 20, 3)
        plain_ms = cuda_ms(lambda: plain(p), 2)
        mask = cache_mask(s_len, t, p, vl, causal)
        live = torch.nonzero(vl).flatten() if rowwise else slice(None)
        lib_ms = device_ms(sdpa_call(q[live], k[live], v[live], mask[live]), 5)
        flops, bytes_ = attention_work(past, valid, t, 28, 4, 128, causal)
        bms, by = bound_ms(flops, bytes_)
        results.append(dict(shape=label, B=b, T=t, S=s_len, past=past, valid=valid,
                            causal=causal, plain_by_row=rowwise, splits=splits, kernel_us=kernel_us, max_abs_err=err,
                            limit_ratio=ratio, rel_err=rel,
                            device_ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bms, bound_by=by, tflops=flops / ms / 1e9))
        log(f"[kernels] {label}: T={t} S={s_len} past={past} max abs err {err:.3e} ({ratio:.2f} x the "
            f"elementwise limit), rel err {rel:.3e}; kernel device {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), call {call_ms:.4f} ms, plain {plain_ms:.3f} ms"
            f"{' (live rows one at a time)' if rowwise else ''}, SDPA device {lib_ms:.4f} ms"
            f"{' (the live rows)' if rowwise else ''}, bound {bms:.4f} ms ({by})")
        del args, q, k, v, mask
        torch.cuda.empty_cache()
    return worst, results


# ---------------------------------------------------------------------------
# phase 3a (cont.): B1-kv8, the decode step over an int8 KV cache
# ---------------------------------------------------------------------------


def kv8_inputs(gen, past, valid, s, h=28, kh=4):
    """A decode step's q and an int8 cache: random codes everywhere, scales
    of a live key's size up to each row's live end and NaN past it."""
    b = len(past)
    dev = DEVICE
    q = torch.randn((b, 1, h, 128), generator=gen, device=dev).bfloat16()
    k8, v8 = (torch.randint(-127, 128, (b, s, kh, 128), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, s, kh), generator=gen, device=dev) * 0.04 + 0.01 for _ in range(2))
    for row, p in enumerate(past):
        ks[row, p + 1:] = float("nan")
        vs[row, p + 1:] = float("nan")
    return (q, k8, v8, ks, vs, torch.tensor(past, dtype=torch.int32, device=dev),
            torch.tensor(valid, dtype=torch.int32, device=dev))


def kv8_work(past, valid, h, kh, d=128):
    """(FLOPs, bytes) of a decode step over an int8 cache: the live codes of
    K and V (a byte an element) and their f32 scales, q and out once."""
    live = sum(p + 1 for p, n in zip(past, valid) if n)
    return 4 * d * h * live, live * kh * 2 * (d + 4) + 2 * len(past) * h * d * 2


def bf16_pair_at(q, k, v, past_len, q_valid):
    """B1's bf16 decode pair at B1-kv8's splits (`kv8_splits`: the same
    arithmetic) over the dequantized view."""
    from bagel_tpu_torch.ops import flash

    out = torch.empty_like(q)
    splits = flash.kv8_splits(q.shape[0], k.shape[2], q.device)
    err = flash._decode(flash._library(), q, k, v, out, past_len, q_valid, q.shape[-1]**-0.5,
                        torch.cuda.current_stream().cuda_stream, splits)
    check(err == 0, f"the bf16 pair at B1-kv8's splits failed ({err})")
    return out


def phase_kv8(cfg):
    """B1-kv8 against its plain twin (kv_dequantize + the plain attention)
    under B1's gate: edge cases, then the serving runtime's slot decode
    shape (8 slots of an 8192-slot cache, ragged pasts), with NaN scales and
    random codes past every live end; bit-identical to B1's bf16 decode
    pair on the dequantized view; a control with one row's scales replaced
    by 1 that the gate must reject; device, call and plain ms against the
    bytes bound and against B1's pair over a bf16 cache of the same live
    keys."""
    from bagel_tpu_torch.ops import flash

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    h, kh = cfg.llm.num_attention_heads, cfg.llm.num_key_value_heads
    worst = 0.0
    cases = [
        ("kv8 decode past=0", [0], [1], 256),
        ("kv8 decode, a tile boundary at past + 1", [63], [1], 1024),
        ("kv8 decode, more splits than live tiles", [70], [1], 1024),
        ("kv8 decode, B=3 of mixed past, a q_valid=0 row", [37, 4000, 1200], [1, 0, 1], MAX_KV),
        ("kv8 decode, the 8-slot serving shape", SLOT_PASTS, [1] * len(SLOT_PASTS), MAX_KV),
    ]
    for label, past, valid, s in cases:
        args = kv8_inputs(gen, past, valid, s, h, kh)
        q, k8, v8, ks, vs, pl, vl = args
        got = flash.flash_decode_kv8(*args)
        want = flash.flash_decode_kv8_plain(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite kernel output")
        for row, n in enumerate(valid):
            check(n or got[row].abs().max().item() == 0.0, f"{label}: a q_valid=0 row is not 0")
        err, ratio, rel = kernel_error(got, want, valid)
        check(within_tol(ratio, rel),
              f"{label}: kernel vs plain max abs {err:.3e} ({ratio:.2f} x the elementwise "
              f"limit), rel {rel:.3e} (limit {KERNEL_REL})")
        kd, vd = flash.kv8_live(k8, v8, ks, vs, pl, vl)
        check(torch.equal(got, bf16_pair_at(q, kd, vd, pl, vl)),
              f"{label}: not bit-identical to B1's bf16 pair on the dequantized view")
        worst = max(worst, err)
        log(f"[kernels] {label}: past={past} max abs err {err:.3e} ({ratio:.2f} x the "
            f"elementwise limit), rel err {rel:.3e}; bit-identical to the bf16 pair on the "
            f"dequantized view; NaN scales past every live end")
    # the slot shape (the last case): control, then times
    row = int(np.argmax(SLOT_PASTS))
    ones = ks.clone()
    ones[row, : SLOT_PASTS[row] + 1] = 1.0
    blind = flash.flash_decode_kv8_plain(q, k8, v8, ones, vs, pl, vl)
    b_err, b_ratio, b_rel = kernel_error(blind, want, valid)
    check(not within_tol(b_ratio, b_rel), f"kv8: the gate accepts row {row}'s scales taken as 1")
    ms = device_ms(lambda: flash.flash_decode_kv8(*args), 20)
    call_ms = cuda_ms(lambda: flash.flash_decode_kv8(*args), 20, 3)
    plain_ms = cuda_ms(lambda: flash.flash_decode_kv8_plain(*args), 2)
    bf16_ms = device_ms(lambda: flash.flash_cached_attention(q, kd, vd, pl, vl, causal=True), 20)
    flops, bytes_ = kv8_work(SLOT_PASTS, valid, h, kh)
    bms, by = bound_ms(flops, bytes_)
    splits = flash.kv8_splits(len(SLOT_PASTS), kh, q.device)
    res = dict(shape=f"B={len(SLOT_PASTS)} S={MAX_KV} H={h} KH={kh} D=128, past={SLOT_PASTS}",
               splits=splits, max_abs_err=worst, device_ms=ms, call_ms=call_ms,
               plain_ms=plain_ms, bf16_pair_device_ms=bf16_ms, bound_ms=bms, bound_by=by,
               bytes=bytes_, gb_per_s=bytes_ / ms / 1e6)
    log(f"[kernels] kv8 control that takes row {row}'s scales as 1 is rejected: max abs "
        f"{b_err:.3e} ({b_ratio:.1f} x the elementwise limit), rel {b_rel:.3e}")
    log(f"[kernels] kv8 at the slot shape ({res['shape']}, {splits} splits of 8 warps): "
        f"device "
        f"{ms:.4f} ms ({bytes_ / ms / 1e6:.0f} GB/s), call {call_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, B1's bf16 pair on the same live keys {bf16_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}, {bytes_ / 1e6:.2f} MB); no one PyTorch call computes it")
    del args, q, k8, v8, ks, vs, kd, vd, ones
    torch.cuda.empty_cache()
    return worst, res


# ---------------------------------------------------------------------------
# phase 3b: B3 sparse_packed_attention against its plain version
# ---------------------------------------------------------------------------


def segment_ids(lens, s):
    """[s] int32: segment i (1-based) over lens[i-1] tokens, then padding."""
    ids = torch.zeros(s, dtype=torch.int32, device=DEVICE)
    start = 0
    for i, n in enumerate(lens, start=1):
        ids[start:start + n] = i
        start += n
    return ids


def train_ids(s):
    """The packed training predicate's ids on s tokens: two documents, each
    with causal text, a full split and a noise split, then 50 padding."""
    doc = segment_ids([300, s - 350], s)
    fan = torch.full((s,), -1, dtype=torch.int32, device=DEVICE)
    noise = fan.clone()
    fan[100:200], fan[200:300], noise[200:300] = 0, 1, 1
    fan[400:500], fan[500:650], noise[500:650] = 2, 3, 3
    return doc, fan, noise


def sparse_inputs(gen, s, h, kh, d, strided=False):
    """bf16 q [s, h, d], k/v [s, kh, d]; strided: views into one fused
    [s, h*d + 2*kh*d] projection, as a fused QKV leaf would give them."""
    if strided:
        qkv = torch.randn((s, (h + 2 * kh) * d), generator=gen, device=DEVICE).bfloat16()
        q, k, v = qkv.split([h * d, kh * d, kh * d], dim=1)
        return q.view(s, h, d), k.view(s, kh, d), v.view(s, kh, d)
    return (torch.randn((s, h, d), generator=gen, device=DEVICE).bfloat16(),
            torch.randn((s, kh, d), generator=gen, device=DEVICE).bfloat16(),
            torch.randn((s, kh, d), generator=gen, device=DEVICE).bfloat16())


def sparse_error(got, want, doc):
    """(max abs error, worst elementwise error in units of its limit, the
    norm-relative error) over the rows that see a key (doc != 0)."""
    rows = doc != 0
    g, w = got[rows].float(), want[rows].float()
    d = (g - w).abs()
    limit = KERNEL_RTOL * w.abs() + KERNEL_ATOL_RMS * w.pow(2).mean().sqrt()
    return (d.max().item(), (d / limit.clamp(min=1e-30)).max().item(),
            (d.norm() / w.norm().clamp(min=1e-30)).item())


def sparse_work(doc, fan, noise, h, kh, d):
    """(FLOPs, bytes) the function needs on these ids: two products over the
    visible (query, key) pairs; q, k, v, out and the ids once each."""
    from bagel_tpu_torch.ops.attention import train_packed_mask

    pairs = int(train_packed_mask(doc, fan, noise).sum())
    s = doc.shape[0]
    return 4 * d * h * pairs, 2 * 2 * s * d * (h + kh) + 3 * 4 * s


def sparse_compare(sf, args, label):
    q, k, v, doc, fan, noise = args
    got = sf.sparse_packed_attention(q, k, v, doc, fan, noise)
    want = sf.sparse_packed_attention_plain(q, k, v, doc, fan, noise)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite kernel output")
    pad = got[doc == 0]
    check(pad.numel() == 0 or pad.abs().max().item() == 0.0,
          f"{label}: padding rows are not exactly 0")
    err, ratio, rel = sparse_error(got, want, doc)
    check(within_tol(ratio, rel),
          f"{label}: kernel vs plain max abs {err:.3e} ({ratio:.2f} x the elementwise "
          f"limit), rel {rel:.3e} (limit {KERNEL_REL})")
    return got, want, err, ratio, rel


def phase_sparse_kernels(vit_s, n_patches, heads, head_dim):
    from bagel_tpu_torch.ops import sparse_flash as sf

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    worst = 0.0
    gap = segment_ids([256], 768)  # q tile 2 (rows 256..383) is all padding
    gap[384:] = 2
    edge = [
        # label, s, h, kh, d, ids (doc, fan, noise), strided, stale NaN
        ("3 packed images + 50 padding", 1000, 16, 16, 72, "seg:300,250,400", False, True),
        ("ragged S=333, strided q/k/v views", 333, 4, 4, 72, "seg:200,100", True, False),
        ("train predicate D=128, GQA 28/4", 700, 28, 4, 128, "train", False, True),
        ("train predicate D=72", 700, 16, 16, 72, "train", False, False),
        ("a q tile with no live key tile", 768, 4, 4, 72, "gap", False, False),
    ]
    for label, s, h, kh, d, kind, strided, stale in edge:
        if kind == "train":
            ids = train_ids(s)
        elif kind == "gap":
            ids = (gap, gap, torch.full_like(gap, -1))
        else:
            seg = segment_ids([int(x) for x in kind[4:].split(",")], s)
            ids = (seg, seg, torch.full_like(seg, -1))
        q, k, v = sparse_inputs(gen, s, h, kh, d, strided)
        args = (q, k, v) + ids
        got, _, err, ratio, rel = sparse_compare(sf, args, label)
        if kind == "gap":
            cnt = sf.kernel_tables(*ids).counts
            check(int(cnt[2]) == 0, f"{label}: q tile 2 has {int(cnt[2])} live key tiles")
        if stale:  # NaN in K/V rows that no query can see changes nothing
            dead = ids[0] == 0
            k[dead] = float("nan")
            v[dead] = float("nan")
            again = sf.sparse_packed_attention(q, k, v, *ids)
            check(torch.equal(again, got), f"{label}: stale NaN leaked into the output")
        worst = max(worst, err)
        note = "; stale NaN in dead rows changes nothing" if stale else ""
        log(f"[kernels] B3 edge {label}: max abs err {err:.3e} ({ratio:.2f} x the elementwise "
            f"limit), rel err {rel:.3e}{note}")

    # negative control: two 70 x 35-patch images packed into one sequence;
    # the plain version with both images merged into one segment must fail
    s2 = 2 * 2450
    seg2 = segment_ids([2450, 2450], s2)
    q, k, v = sparse_inputs(gen, s2, heads, heads, head_dim)
    noise2 = torch.full_like(seg2, -1)
    _, want, err, ratio, rel = sparse_compare(sf, (q, k, v, seg2, seg2, noise2),
                                              "two packed images")
    worst = max(worst, err)
    merged = (seg2 != 0).to(torch.int32)
    blind = sf.sparse_packed_attention_plain(q, k, v, merged, merged, noise2)
    b_err, b_ratio, b_rel = sparse_error(blind, want, seg2)
    check(not within_tol(b_ratio, b_rel),
          "the gate accepts an attention that merges two images into one segment")
    log(f"[kernels] B3 two packed images (S={s2}): max abs err {err:.3e} ({ratio:.2f} x the "
        f"limit), rel {rel:.3e}; control that merges the images is rejected: max abs "
        f"{b_err:.3e} ({b_ratio:.1f} x the elementwise limit), rel {b_rel:.3e}")
    del q, k, v, want, blind

    # the main path's shape: one 980 px image, n_patches tokens in a block
    # of vit_s, SigLIP's heads and head dim
    seg = segment_ids([n_patches], vit_s)
    noise = torch.full_like(seg, -1)
    q, k, v = sparse_inputs(gen, vit_s, heads, heads, head_dim)
    _, _, err, ratio, rel = sparse_compare(sf, (q, k, v, seg, seg, noise), "main path")
    worst = max(worst, err)
    # the tower builds the kernel's tables once and shares them across its
    # layers: time the launch with them built, and their build alone
    tables_ms = cuda_ms(lambda: sf.kernel_tables(seg, seg, noise), 5)
    tables = sf.kernel_tables(seg, seg, noise)

    def launch(t=tables):
        return sf.sparse_packed_attention(q, k, v, seg, seg, noise, tables=t)

    call_ms = cuda_ms(launch, 20, 3)
    # A/B of the full-tile flags: the same launch with every flag cleared, so
    # that every tile takes the per-element mask; the output must not change
    masked = tables._replace(entries=tables.entries & ~sf.FULL_TILE,
                             t_entries=tables.t_entries & ~sf.FULL_TILE)
    check(torch.equal(launch(masked), launch()), "main path: the full-tile flags change the output")
    ab = [device_ms(lambda: launch(t), 20) for t in (masked, tables, tables, masked)]
    log(f"[kernels] B3 main path A/B of the full-tile flags, device time: masked {ab[0]:.4f}, "
        f"flagged {ab[1]:.4f}, flagged {ab[2]:.4f}, masked {ab[3]:.4f} ms")
    plain_ms = cuda_ms(lambda: sf.sparse_packed_attention_plain(q, k, v, seg, seg, noise), 2)
    mask = (seg[:, None] == seg[None, :]) & (seg[:, None] != 0)
    sdpa = sdpa_call(q[None], k[None], v[None], mask[None, None])
    # kernel and SDPA in turns, in device time: SDPA, kernel, kernel, SDPA
    turns = [device_ms(fn, 20) for fn in (sdpa, launch, launch, sdpa)]
    ms, lib_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    flops, bytes_ = sparse_work(seg, seg, noise, heads, heads, head_dim)
    bms, by = bound_ms(flops, bytes_)
    log(f"[kernels] B3 main path S={vit_s} ({n_patches} patches), H={heads}, D={head_dim}: "
        f"max abs err {err:.3e} ({ratio:.2f} x the elementwise limit), rel err {rel:.3e}; "
        f"device time in turns SDPA {turns[0]:.4f}, kernel {turns[1]:.4f}, kernel "
        f"{turns[2]:.4f}, SDPA {turns[3]:.4f} ms; kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), call {call_ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"SDPA {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}); the tables, built once per "
        f"image: {tables_ms:.4f} ms")
    main = dict(shape=f"SigLIP S={vit_s}, {n_patches} patches, H={heads}, D={head_dim}",
                tables_ms=tables_ms, full_tile_ab_ms=ab, turns_ms=turns,
                max_abs_err=err, limit_ratio=ratio, rel_err=rel, device_ms=ms,
                call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by, tflops=flops / ms / 1e9)
    del q, k, v, mask
    torch.cuda.empty_cache()
    return worst, main


# ---------------------------------------------------------------------------
# phase 3c: B5 int8_matmul against its plain version
# ---------------------------------------------------------------------------


def int8_operands(gen, m, k, n):
    """Random codes and scales; the weight k-major, as the load-time helper
    lays every w8a8 weight out (B5 refuses a row-major one)."""
    from bagel_tpu_torch.utils.quant import to_kmajor

    dev = DEVICE
    return (torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8),
            (torch.rand((m, 1), generator=gen, device=dev) + 0.5) / 127,
            to_kmajor(torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                                    dtype=torch.int8)),
            (torch.rand((n,), generator=gen, device=dev) + 0.5) / 127,
            torch.randn((n,), generator=gen, device=dev).bfloat16())


def phase_int8_matmul(cfg, prefill_t):
    """B5 bit for bit against its plain version (float64 products of the
    codes, exact) at the w8a8 text-to-image shapes, M=1 and a ragged
    M/N/K; times at the gen-block shapes the main path runs (fused QKV and
    gate-up leaves) and at the unfused gate."""
    from bagel_tpu_torch.ops import int8_matmul as m8

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    d, f = cfg.llm.hidden_size, cfg.llm.intermediate_size
    qkv = (cfg.llm.num_attention_heads + 2 * cfg.llm.num_key_value_heads) * cfg.llm.head_dim
    kv = cfg.llm.num_key_value_heads * cfg.llm.head_dim
    # the gen expert's rows of a 1024 px denoise call: 3 CFG branches x 4096
    # latents (the block's 2 boundary tokens take the und expert: 6 rows)
    gen_rows = 3 * (PX // cfg.latent_downsample) ** 2
    cases = [  # label, M, K, N, bias, timed
        ("gen qkv (fused)", gen_rows, d, qkv, True, True),
        ("gen o", gen_rows, d, d, False, True),
        ("gen gate_up (fused)", gen_rows, d, 2 * f, False, True),
        ("gen down", gen_rows, f, d, False, True),
        ("gen gate", gen_rows, d, f, False, True),
        ("gen q", gen_rows, d, d, True, False),
        ("gen k / v", gen_rows, d, kv, True, False),
        ("prefill qkv", prefill_t, d, qkv, True, False),
        ("prefill gate_up", prefill_t, d, 2 * f, False, False),
        ("prefill down", prefill_t, f, d, False, False),
        ("und rows of the gen block, qkv", 6, d, qkv, True, False),
        ("M=1 down", 1, f, d, False, False),
        ("ragged M/N/K", 77, 1040, 528, True, False),
    ]
    results = []
    for label, m, k, n, with_bias, timed in cases:
        xq, xs, wq, ws, b = int8_operands(gen, m, k, n)
        b = b if with_bias else None
        got = m8.int8_matmul(xq, xs, wq, ws, b)
        want = m8.int8_matmul_plain(xq, xs, wq, ws, b)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"B5 {label}: kernel differs from the plain version in "
              f"{int((got != want).sum())} of {got.numel()} values")
        row = dict(shape=label, M=m, K=k, N=n, bias=with_bias, bit_identical=True)
        if label == "gen gate":  # negative control: ws reversed across columns
            blind = m8.int8_matmul_plain(xq, xs, wq, ws.flip(0), b)
            check(not torch.equal(blind, got), "B5: the gate accepts ws reversed")
            log(f"[kernels] B5 {label}: control with ws reversed is rejected "
                f"({int((blind != got).sum())} of {got.numel()} values differ)")
            del blind
        if timed:
            ms = device_ms(lambda: m8.int8_matmul(xq, xs, wq, ws, b), 10)
            call_ms = cuda_ms(lambda: m8.int8_matmul(xq, xs, wq, ws, b), 10, 2)
            plain_ms = cuda_ms(lambda: m8.int8_matmul_plain(xq, xs, wq, ws, b), 2)

            def library():  # torch._int_mm + the same epilogue (a yardstick only)
                acc = torch._int_mm(xq, wq)
                out = acc.float() * xs * ws
                return (out + b.float() if b is not None else out).bfloat16()

            try:
                library()
            except RuntimeError as err:  # the library call refuses the shape
                lib_ms = None
                log(f"[kernels] B5 {label}: torch._int_mm refused: {err}")
            else:
                lib_ms = device_ms(library, 10)
            ops = 2 * m * n * k
            bms, by = bound_ms_at(ops, m * k + k * n + 2 * m * n + 4 * (m + n), PEAK_INT8)
            row.update(device_ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bms, bound_by=by, tops=ops / ms / 1e9)
            lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
            log(f"[kernels] B5 {label}: M={m} K={k} N={n}: bit-identical; kernel device "
                f"{ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s), call {call_ms:.4f} ms, plain "
                f"{plain_ms:.3f} ms, torch._int_mm + epilogue device {lib}, bound {bms:.4f} ms "
                f"({by})")
        else:
            log(f"[kernels] B5 {label}: M={m} K={k} N={n}: bit-identical")
        results.append(row)
        del xq, xs, wq, ws, b, got, want
        torch.cuda.empty_cache()
    return results


def phase_quantize_rows(cfg):
    """The w8a8 activation quantization pass against its plain version, bit
    for bit (codes and scales), at the four path shapes (the gen expert's
    rows of a 1024 px denoise call into qkv, o, gate_up: K = hidden; into
    down: K = FFN) and a ragged one; bf16 rows of mixed magnitude with a row
    of zeros and a row of ties at .5. Device time against the bytes bound
    (x read once, codes and scales written once)."""
    from bagel_tpu_torch.ops import int8_matmul as m8

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    d, f = cfg.llm.hidden_size, cfg.llm.intermediate_size
    rows = 3 * (PX // cfg.latent_downsample) ** 2
    cases = [("into gen qkv", rows, d), ("into gen o", rows, d), ("into gen gate_up", rows, d),
             ("into gen down", rows, f), ("ragged", 77, 1040)]
    results = []
    for label, m, k in cases:
        x = (torch.randn((m, k), generator=gen, device=DEVICE)
             * (torch.rand((m, 1), generator=gen, device=DEVICE) * 50)).bfloat16()
        x[1] = 0.0
        x[2] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5],
                            device=DEVICE).repeat(k // 8).bfloat16()
        xq, xs = m8.quantize_rows(x)
        want_q, want_s = m8.quantize_rows_plain(x)
        torch.cuda.synchronize()
        check(torch.equal(xq, want_q) and torch.equal(xs, want_s),
              f"quantize_rows {label}: {int((xq != want_q).sum())} codes and "
              f"{int((xs != want_s).sum())} scales differ from the plain version")
        row = dict(shape=label, M=m, K=k, bit_identical=True)
        if m > 1000:
            ms = device_ms(lambda: m8.quantize_rows(x), 20)
            call_ms = cuda_ms(lambda: m8.quantize_rows(x), 20, 2)
            plain_ms = cuda_ms(lambda: m8.quantize_rows_plain(x), 5)
            bytes_ = 2 * m * k + m * k + 4 * m
            bms, by = bound_ms_at(0, bytes_, PEAK_INT8)
            row.update(device_ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=bms, bound_by=by, gb_per_s=bytes_ / ms / 1e6)
            log(f"[kernels] quantize_rows {label}: M={m} K={k}: codes and scales bit-identical; "
                f"kernel device {ms:.4f} ms ({bytes_ / ms / 1e6:.0f} GB/s), call {call_ms:.4f} "
                f"ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by})")
        else:
            log(f"[kernels] quantize_rows {label}: M={m} K={k}: codes and scales bit-identical")
        results.append(row)
        del x, xq, xs, want_q, want_s
        torch.cuda.empty_cache()
    return results


def phase_split_rows(cfg):
    """A w8a8 row-parallel leaf's split quantization (tp > 1: each row's
    absmax of this rank's slice, MAX over tp, the codes with the whole
    row's scale) and B5's f32 instance (its partial sums), at the local
    shapes of tp = 2 and 4: o (K = hidden / tp) and down (K = FFN / tp),
    M = 1, 8 and a ragged 77. The reduce-only and the given-scale kernels
    bit for bit against their plain versions (the given scale the larger
    absmax of another rank's slice), a control (the codes of a scale 1 %
    off) that must differ; B5's f32 instance bit for bit against the plain
    epilogue before its rounding, and its bf16 rounding equal to B5's bf16
    instance. Device times at tp = 2's local shapes of the 1024 px gen
    block's rows (3 x 4096), beside their bounds."""
    from bagel_tpu_torch.ops import int8_matmul as m8

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    d, f = cfg.llm.hidden_size, cfg.llm.intermediate_size
    gen_rows = 3 * (PX // cfg.latent_downsample) ** 2
    rows = []
    for tp in (2, 4):
        for leaf, k in (("o", d // tp), ("down", f // tp)):
            for m in (1, 8, 77) + ((gen_rows,) if tp == 2 else ()):
                # this rank's slice and another's: bf16 rows of mixed magnitude
                x, other = ((torch.randn((m, k), generator=gen, device=DEVICE)
                             * (torch.rand((m, 1), generator=gen, device=DEVICE) * 50)).bfloat16()
                            for _ in range(2))
                amax = m8.row_absmax(x)
                scale = m8.row_scale(torch.maximum(amax, m8.row_absmax_plain(other)))
                xq, xs = m8.quantize_rows(x, scale)
                torch.cuda.synchronize()
                same_amax = torch.equal(amax, m8.row_absmax_plain(x))
                same_q = torch.equal(xq, m8.quantize_rows_plain(x, scale)[0])
                label = f"tp = {tp} {leaf} M={m} K={k}"
                check(same_amax, f"row_absmax {label}: differs from the plain version in "
                                 f"{int((amax != m8.row_absmax_plain(x)).sum())} rows")
                check(same_q, f"quantize_rows_given {label}: codes differ from the plain version")
                blind = m8.quantize_rows_plain(x, scale * 1.01)[0]
                check(not torch.equal(blind, xq),
                      f"quantize_rows_given {label}: the gate accepts a scale 1 % off")
                row = dict(shape=label, tp=tp, leaf=leaf, M=m, K=k, bit_identical=True,
                           control_codes_differ=int((blind != xq).sum()))
                wq = to_kmajor_random(gen, k, d)
                ws = (torch.rand((d,), generator=gen, device=DEVICE) + 0.5) / 127
                got = m8.int8_matmul(xq, xs, wq, ws, out_dtype=torch.float32)
                want = m8.int8_matmul_plain(xq, xs, wq, ws, out_dtype=torch.float32)
                bf16 = m8.int8_matmul(xq, xs, wq, ws)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"B5 f32 {label} N={d}: differs from the plain "
                                              f"epilogue in {int((got != want).sum())} values")
                check(torch.equal(got.bfloat16(), bf16),
                      f"B5 f32 {label}: its rounding differs from the bf16 instance")
                row["b5_f32_bit_identical"] = True
                if m == gen_rows:
                    bytes_abs, bytes_given = 2 * m * k + 4 * m, 2 * m * k + 4 * m + m * k
                    ops = 2 * m * d * k
                    bytes_b5 = m * k + k * d + 4 * m * d + 4 * (m + d)
                    row.update(
                        absmax_device_ms=device_ms(lambda: m8.row_absmax(x), 20),
                        absmax_call_ms=cuda_ms(lambda: m8.row_absmax(x), 20, 2),
                        absmax_plain_ms=cuda_ms(lambda: m8.row_absmax_plain(x), 5),
                        absmax_library_ms=device_ms(lambda: torch.linalg.vector_norm(
                            x, float("inf"), dim=-1, keepdim=True, dtype=torch.float32), 20),
                        absmax_bound_ms=bound_ms_at(0, bytes_abs, PEAK_INT8)[0],
                        given_device_ms=device_ms(lambda: m8.quantize_rows(x, scale), 20),
                        given_call_ms=cuda_ms(lambda: m8.quantize_rows(x, scale), 20, 2),
                        given_plain_ms=cuda_ms(lambda: m8.quantize_rows_plain(x, scale), 5),
                        given_bound_ms=bound_ms_at(0, bytes_given, PEAK_INT8)[0],
                        whole_device_ms=device_ms(lambda: m8.quantize_rows(x), 20),
                        b5_f32_device_ms=device_ms(
                            lambda: m8.int8_matmul(xq, xs, wq, ws, out_dtype=torch.float32), 10),
                        b5_f32_call_ms=cuda_ms(
                            lambda: m8.int8_matmul(xq, xs, wq, ws, out_dtype=torch.float32),
                            10, 2),
                        b5_f32_plain_ms=cuda_ms(lambda: m8.int8_matmul_plain(
                            xq, xs, wq, ws, out_dtype=torch.float32), 2),
                        b5_bf16_device_ms=device_ms(lambda: m8.int8_matmul(xq, xs, wq, ws), 10),
                        b5_f32_library_ms=device_ms(
                            lambda: torch._int_mm(xq, wq).float() * xs * ws, 10),
                        b5_f32_bound_ms=bound_ms_at(ops, bytes_b5, PEAK_INT8)[0],
                        b5_f32_bound_by=bound_ms_at(ops, bytes_b5, PEAK_INT8)[1])
                    log(f"[kernels] split rows {label}: row_absmax device "
                        f"{row['absmax_device_ms']:.4f} ms (bound {row['absmax_bound_ms']:.4f}, "
                        f"plain {row['absmax_plain_ms']:.3f}), quantize_rows_given device "
                        f"{row['given_device_ms']:.4f} ms (bound {row['given_bound_ms']:.4f}, "
                        f"plain {row['given_plain_ms']:.3f}), the whole pass "
                        f"{row['whole_device_ms']:.4f} ms; B5 f32 N={d} device "
                        f"{row['b5_f32_device_ms']:.4f} ms (bf16 instance "
                        f"{row['b5_bf16_device_ms']:.4f}, torch._int_mm + epilogue "
                        f"{row['b5_f32_library_ms']:.4f}, plain {row['b5_f32_plain_ms']:.3f}, "
                        f"bound {row['b5_f32_bound_ms']:.4f} ({row['b5_f32_bound_by']}))")
                else:
                    log(f"[kernels] split rows {label}: absmax, codes and B5 f32 (N={d}) "
                        f"bit-identical; control codes of a scale 1 % off: "
                        f"{row['control_codes_differ']} differ")
                rows.append(row)
                del x, other, amax, scale, xq, xs, wq, ws, got, want, bf16, blind
    torch.cuda.empty_cache()
    return rows


def to_kmajor_random(gen, k, n):
    """A random int8 [k, n] weight laid out k-major (B5's layout)."""
    from bagel_tpu_torch.utils.quant import to_kmajor

    return to_kmajor(torch.randint(-127, 128, (k, n), generator=gen, device=DEVICE,
                                   dtype=torch.int8))


# ---------------------------------------------------------------------------
# phase 3d: B4 int4_matmul against its plain version
# ---------------------------------------------------------------------------


def bf16_ulp(x):
    """One bf16 ulp of each value (of the smallest normal near 0)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126))) - 7)


def int4_error(got, want, x, w):
    """Worst |kernel - plain| in units of its limit: one bf16 ulp of the
    plain value plus the f32 sums' own error bound, K 2^-24 sum |x w| (the
    two add the same exact products in different orders)."""
    sum_err = x.shape[1] * 2.0 ** -24 * (x.float().abs() @ w.float().abs())
    limit = bf16_ulp(want.float()) + sum_err
    d = (got.float() - want.float()).abs()
    return d.max().item(), (d / limit).max().item()


# torch.profiler now and then hands back no CUDA activity at all for a
# session (seen on the card once in several runs, with kernels that ran): a
# session that recorded nothing is taken again, at most this many times
PROFILE_TRIES = 6


def profile_session(attempt: int):
    """A torch.profiler session recording the card's activity. A retry waits
    a little and, every other time, records the host's activity too."""
    from torch.profiler import ProfilerActivity, profile

    if attempt:
        time.sleep(0.2 * attempt)
    activities = [ProfilerActivity.CUDA]
    if attempt % 2:
        activities.insert(0, ProfilerActivity.CPU)
    return profile(activities=activities)


def kernel_device_us(fn, calls: int = 20) -> dict:
    """{kernel name: device µs a call} over `calls` calls of fn(), from
    torch.profiler's record of the card's activity (reported, not gated: a
    run of empty sessions leaves it empty)."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile_session(attempt) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        # the card's own records (a session that also records the host
        # lists its runtime calls and ops too)
        stats = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        names = (e.key.replace("(anonymous namespace)::", "").split("(")[0].split()[-1]
                 for e in stats)
        times = {name: e.device_time_total / calls
                 for name, e in zip(names, stats) if e.device_time_total > 0}
        if times:
            break
    return times


def phase_int4_matmul(cfg):
    """B4 against its plain version at the decode shapes of every linear
    (fused and unfused leaves), M in {1, 3, 64}; a control with the nibbles
    swapped. Every call is one launch (the launch counter, and the kernel
    nodes of one call captured in a CUDA graph), two calls are
    bit-identical (a fixed order of the split sums), and the fused bias
    epilogue equals the unbiased output with JAX's bias rounding after it,
    bit for bit. Times at M=1 (decode); one decode token's 112 launches as
    a cold-L2 graph."""
    from bagel_tpu_torch.ops import int4_matmul as m4
    from bagel_tpu_torch.utils.cuda_graph import kernels_on_card
    from bagel_tpu_torch.utils.quant import dequantize_weight4, quantize_weight_int4

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    fused, shapes = int4_shapes(cfg)
    results, worst = [], 0.0
    for label, k, n in shapes:
        w = torch.randn((k, n), generator=gen, device=DEVICE) * 0.02
        leaf = quantize_weight_int4(w)
        del w
        wd = dequantize_weight4(leaf, torch.bfloat16)
        bias = torch.randn((n,), generator=gen, device=DEVICE).bfloat16()
        for m in (1, 3, 64):
            x = torch.randn((m, k), generator=gen, device=DEVICE).bfloat16()
            before = m4.int4_matmul.launches
            got = m4.int4_matmul(x, leaf["w_p4"], leaf["scale4"])
            again = m4.int4_matmul(x, leaf["w_p4"], leaf["scale4"])
            biased = m4.int4_matmul(x, leaf["w_p4"], leaf["scale4"], bias)
            want = m4.int4_matmul_plain(x, leaf["w_p4"], leaf["scale4"])
            torch.cuda.synchronize()
            check(m4.int4_matmul.launches == before + 3, f"B4 {label} M={m}: not one launch a call")
            check(torch.equal(got, again), f"B4 {label} M={m}: two calls differ")
            check(torch.equal(biased, (got.float() + bias.float()).bfloat16()),
                  f"B4 {label} M={m}: the bias epilogue does not round as JAX does")
            err, ratio = int4_error(got, want, x, wd)
            check(ratio <= 1.0, f"B4 {label} M={m}: max abs {err:.3e} ({ratio:.2f} x the limit)")
            worst = max(worst, err)
            rps = m4.grid(k, n, m)
            row = dict(shape=label, M=m, K=k, N=n, max_abs_err=err, limit_ratio=ratio,
                       split_rows=rps, blocks=m4.blocks(k, n, m, rps),
                       on_main_path=(label, k, n) in fused)
            if m == 1 and label == "down":  # negative control: nibbles swapped
                p = leaf["w_p4"]
                swapped = (p >> 4) | (p << 4)
                blind = m4.int4_matmul_plain(x, swapped, leaf["scale4"])
                b_err, b_ratio = int4_error(got, blind, x, wd)
                check(b_ratio > 1.0, "B4: the gate accepts swapped nibbles")
                log(f"[kernels] B4 {label}: control with the nibbles swapped is rejected: "
                    f"max abs {b_err:.3e} ({b_ratio:.1f} x the limit)")
                # one launch a call, as the card records it (K split here)
                names = kernels_on_card(lambda: m4.int4_matmul(x, leaf["w_p4"], leaf["scale4"],
                                                               bias))
                check(len(names) == 1 and "int4_matmul_kernel" in names[0],
                      f"B4 {label}: one biased call ran {names} on the card, not one kernel")
                log(f"[kernels] B4 {label}: one biased call ran one kernel on the card "
                    f"(its CUDA graph): {short_name(names[0])}")
            if m == 1:
                def call():
                    return m4.int4_matmul(x, leaf["w_p4"], leaf["scale4"])

                # device time over 50 calls on one weight: warm in L2 where
                # it is smaller than the 50 MB cache (the token below is cold)
                ms, call_ms, h_us = device_ms(call, 50), cuda_ms(call, 50, 3), host_us(call)
                plain_ms = cuda_ms(lambda: m4.int4_matmul_plain(x, leaf["w_p4"], leaf["scale4"]),
                                   5)
                lib_ms = device_ms(lambda: torch.matmul(x, wd), 50)
                bytes_ = k * n // 2 + (k // 128) * n * 4 + 2 * m * (k + n)
                bms, by = bound_ms_at(2 * m * k * n, bytes_, PEAK_FLOPS)
                row.update(device_ms=ms, call_ms=call_ms, host_us=h_us, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bms, bound_by=by,
                           gb_per_s=bytes_ / ms / 1e6)
                log(f"[kernels] B4 {label}: K={k} N={n} M=1, {rps} packed rows a split, "
                    f"{row['blocks']} blocks: max abs err {err:.3e} ({ratio:.2f} x the limit), "
                    f"two calls bit-identical, bias epilogue exact; kernel device {ms:.4f} ms "
                    f"({bytes_ / ms / 1e6:.0f} GB/s), call {call_ms:.4f} ms, host {h_us:.1f} µs "
                    f"a call, plain {plain_ms:.3f} ms, torch.matmul on the bf16 weight device "
                    f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
            else:
                log(f"[kernels] B4 {label}: K={k} N={n} M={m}: max abs err {err:.3e} "
                    f"({ratio:.2f} x the limit)")
            results.append(row)
        del leaf, wd
        torch.cuda.empty_cache()
    token = int4_token(cfg, m4, gen, fused, results)
    return worst, results, token


def int4_shapes(cfg):
    """B4's decode shapes (label, K, N): the fused leaves the main path
    runs, and all of them with the unfused ones."""
    d, f = cfg.llm.hidden_size, cfg.llm.intermediate_size
    qkv = (cfg.llm.num_attention_heads + 2 * cfg.llm.num_key_value_heads) * cfg.llm.head_dim
    kv = cfg.llm.num_key_value_heads * cfg.llm.head_dim
    fused = [("qkv", d, qkv), ("o", d, d), ("gate_up", d, 2 * f), ("down", f, d)]
    return fused, fused + [("q", d, d), ("k / v", d, kv), ("gate / up", d, f)]


def int4_split_sweep(rounds: int = 2) -> dict:
    """Not part of the smoke: B4's device time at M=1 at each decode shape
    for every split of K the kernel takes (16, 32, 64, ... packed rows up
    to one split, within the workspace), the splits timed in turns,
    `rounds` times (forward, back, ...), beside the grid helper's choice.
    Run:  python3 -c "import chip_smoke as c; c.phase_device(); c.phase_build(); c.int4_split_sweep()"
    """
    from bagel_tpu_torch.configs import BagelConfig
    from bagel_tpu_torch.ops import int4_matmul as m4
    from bagel_tpu_torch.utils.quant import dequantize_weight4, quantize_weight_int4

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    out = {}
    for label, k, n in int4_shapes(BagelConfig())[1]:
        leaf = quantize_weight_int4(torch.randn((k, n), generator=gen, device=DEVICE) * 0.02)
        wd = dequantize_weight4(leaf, torch.bfloat16)
        x = torch.randn((1, k), generator=gen, device=DEVICE).bfloat16()
        want = m4.int4_matmul_plain(x, leaf["w_p4"], leaf["scale4"])
        splits, rps = [], 16
        while True:
            if rps >= k // 2 or m4.blocks(k, n, 1, rps) <= m4._MAX_BLOCKS:
                splits.append(rps)
            if rps >= k // 2:
                break
            rps = 32 if rps == 16 else 64 if rps == 32 else rps * 2
        times = {r: [] for r in splits}
        for turn in range(rounds):
            for r in splits if turn % 2 == 0 else splits[::-1]:
                def call(r=r):
                    return m4._run(x, leaf["w_p4"], leaf["scale4"], None, r)

                check(int4_error(call(), want, x, wd)[1] <= 1.0,
                      f"B4 sweep {label}: split {r} fails the gate")
                times[r].append(device_ms(call, 50))
        out[label] = {f"{r} rows, {m4.blocks(k, n, 1, r)} blocks": t for r, t in times.items()}
        log(f"[sweep] B4 {label} K={k} N={n} M=1, device ms by packed rows a split: "
            f"{json.dumps(out[label])}; the helper's choice: {m4.grid(k, n)} rows")
        del leaf, wd
        torch.cuda.empty_cache()
    return out


def decode_split_sweep(rounds: int = 2) -> dict:
    """Not part of the smoke: B1's decode pair at the smoke's decode shape
    (B=1, S=8192, past 4975, 28/4 heads) for several numbers of splits a KV
    head, device µs, in turns (forward, back, ...), beside `decode_splits`'
    choice.
    Run:  python3 -c "import chip_smoke as c; c.phase_device(); c.phase_build(); c.decode_split_sweep()"
    """
    from bagel_tpu_torch.ops import flash

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    q, k, v, p, vl = attention_inputs(gen, 1, 1, MAX_KV, 28, 4, [4975], [1])
    want = flash.flash_cached_attention_plain(q, k, v, p, vl, causal=True)
    lib, out = flash._library(), torch.empty_like(q)
    splits = (8, 17, 25, 33, 44, 66, 132)
    times = {n: [] for n in splits}
    for turn in range(rounds):
        for n in splits if turn % 2 == 0 else splits[::-1]:
            def call(n=n):
                stream = torch.cuda.current_stream().cuda_stream  # the capture's, in device_ms
                check(flash._decode(lib, q, k, v, out, p, vl, 128**-0.5, stream, n) == 0,
                      f"decode sweep: launch with {n} splits failed")
                return out

            check(within_tol(*kernel_error(call(), want, [1])[1:]),
                  f"decode sweep: {n} splits fail the gate")
            times[n].append(device_ms(call, 50) * 1e3)
    log(f"[sweep] B1 decode pair, device µs by splits a KV head: {json.dumps(times)}; "
        f"decode_splits' choice: {flash.decode_splits(1, 4, q.device)}")
    return times


def kv8_split_sweep(rounds: int = 2) -> dict:
    """Not part of the smoke: B1-kv8 at the 8-slot serving shape (SLOT_PASTS
    of an 8192-slot cache, 28/4 heads) at several numbers of splits a KV
    head, device µs in turns (forward, back, ...), each held to the gate and
    bit for bit to B1's bf16 pair at the same splits on the dequantized view
    (whose µs it reports beside), with `kv8_splits`' choice.
    Run:  python3 -c "import chip_smoke as c; c.phase_device(); c.phase_build(); c.kv8_split_sweep()"
    """
    from bagel_tpu_torch.ops import flash

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    valid = [1] * len(SLOT_PASTS)
    q, k8, v8, ks, vs, pl, vl = kv8_inputs(gen, SLOT_PASTS, valid, MAX_KV)
    kd, vd = flash.kv8_live(k8, v8, ks, vs, pl, vl)
    want = flash.flash_decode_kv8_plain(q, k8, v8, ks, vs, pl, vl)
    lib, out, out16 = flash._library(), torch.empty_like(q), torch.empty_like(q)
    splits = (5, 8, 11, 16, 22, 33)
    times = {n: [] for n in splits}
    bf16 = {n: [] for n in splits}
    for turn in range(rounds):
        for n in splits if turn % 2 == 0 else splits[::-1]:
            def call(n=n):
                stream = torch.cuda.current_stream().cuda_stream  # the capture's, in device_ms
                check(flash._decode_kv8(lib, q, k8, v8, ks, vs, out, pl, vl, 128**-0.5, stream,
                                        n) == 0, f"kv8 sweep: {n} splits failed")
                return out

            def pair(n=n):
                stream = torch.cuda.current_stream().cuda_stream
                check(flash._decode(lib, q, kd, vd, out16, pl, vl, 128**-0.5, stream, n) == 0,
                      f"kv8 sweep: the bf16 pair at {n} splits failed")
                return out16

            check(within_tol(*kernel_error(call(), want, valid)[1:]),
                  f"kv8 sweep: {n} splits fail the gate")
            check(torch.equal(call(), pair()),
                  f"kv8 sweep: {n} splits not bit-identical to the bf16 pair at {n}")
            times[n].append(device_ms(call, 50) * 1e3)
            bf16[n].append(device_ms(pair, 50) * 1e3)
    log(f"[sweep] B1-kv8 at the slot shape, device µs by splits: {json.dumps(times)}; "
        f"the bf16 pair at each: {json.dumps(bf16)}; kv8_splits' choice: "
        f"{flash.kv8_splits(len(SLOT_PASTS), 4, q.device)}")
    return dict(kv8=times, bf16=bf16)


def int4_token(cfg, m4, gen, fused, results):
    """One decode token's B4 work: a CUDA graph of the 112 launches (28
    layers x the 4 fused linears) over 28 layers' own int4 weights (3.47
    GB: each weight is cold in the 50 MB L2 when it is read), its device
    time; the same 112 calls back to back (call time, host included); the
    plain version over the same weights; and the yardstick, torch.matmul
    over 28 layers' own bf16 weights, in device time."""
    L = cfg.llm.num_hidden_layers
    xs = {k: torch.randn((1, k), generator=gen, device=DEVICE).bfloat16() for _, k, _ in fused}
    layers = [[(torch.randint(0, 256, (k // 2, n), generator=gen, device=DEVICE,
                              dtype=torch.uint8),
                torch.rand((k // 128, n), generator=gen, device=DEVICE) * 1e-2 + 1e-3)
               for _, k, n in fused] for _ in range(L)]
    nbytes = sum(w.numel() + s.numel() * 4 for layer in layers for w, s in layer)

    def token(fn=m4.int4_matmul):
        for layer in layers:
            for w, s in layer:
                fn(xs[w.shape[0] * 2], w, s)

    ms = device_ms(token, 3)
    call_ms = cuda_ms(token, 5, 1)
    plain_ms = cuda_ms(lambda: token(m4.int4_matmul_plain), 2, 1)
    del layers
    torch.cuda.empty_cache()
    bf16 = [[torch.randn((k, n), generator=gen, device=DEVICE, dtype=torch.bfloat16)
             for _, k, n in fused] for _ in range(L)]

    def token_lib():
        for layer in bf16:
            for w in layer:
                torch.matmul(xs[w.shape[0]], w)

    lib_ms = device_ms(token_lib, 3)
    lib_gb = sum(w.numel() * 2 for layer in bf16 for w in layer) / 1e9
    del bf16
    torch.cuda.empty_cache()
    main = [r for r in results if r["on_main_path"] and r["M"] == 1]
    token = dict(device_ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                 weight_gb=nbytes / 1e9, library_weight_gb=lib_gb,
                 bound_ms=L * sum(r["bound_ms"] for r in main))
    log(f"[kernels] B4 one decode token ({L} layers x 4 fused linears over {nbytes / 1e9:.2f} GB "
        f"of distinct int4 weights, cold in L2): kernel device {ms:.3f} ms "
        f"({nbytes / ms / 1e6:.0f} GB/s, one CUDA graph), call {call_ms:.3f} ms (the 112 calls "
        f"back to back), plain {plain_ms:.2f} ms; torch.matmul over {lib_gb:.1f} GB of "
        f"distinct bf16 weights device {lib_ms:.3f} ms; bound {token['bound_ms']:.3f} ms (bytes)")
    return token


# ---------------------------------------------------------------------------
# phase 3e: B2 flash_cached_attention_q8 against its plain version
# ---------------------------------------------------------------------------


def q8_compare(flash, args, causal):
    """The prep pass against its plain version (every code of every row's
    live keys and every scale, bit for bit; `q8_live` zeroes the codes past
    the live keys, which the pass leaves unspecified), then the int8
    kernel and its plain version on the same codes and scales at the
    kernel's key tile: (prepared inputs, kernel out, plain out, err, ratio,
    rel)."""
    q, k, v, past, valid = args
    prep = flash.q8_prep(q, k, v, past, valid)
    plain_prep = flash.q8_prep_plain(q, k, v, past, valid)
    live = (prep[0], *flash.q8_live(prep[1], prep[2], past, valid), *prep[3:])
    for name, got_, want_ in zip(("q8", "k8", "v8t", "qs", "ks", "vs"), live, plain_prep):
        check(got_.shape == want_.shape and torch.equal(got_, want_),
              f"q8_prep: {name} differs from the plain version's")
    del plain_prep, live
    got = flash.flash_cached_attention_q8(*prep, past, valid, causal=causal)
    want = flash.flash_q8_plain(*prep, past, valid, causal=causal, block_k=flash.Q8_BLOCK_K)
    torch.cuda.synchronize()
    err, ratio, rel = kernel_error(got, want, valid.tolist())
    return prep, got, want, err, ratio, rel


def prep_bytes(b, t, s, h, kh, past, valid):
    """Bytes the prep must move: q and each row's live k/v read once (bf16),
    the codes written once (q8, and the live keys' codes of k8 and V^T) and
    the scales."""
    live = sum(min(p + n, s) for p, n in zip(past, valid))
    return 3 * b * t * h * 128 + 3 * 2 * live * kh * 128 + 4 * b * (h + 2 * kh)


def phase_flash_q8(cfg, prompt_len, prefill_t, vqa):
    from bagel_tpu_torch.ops import flash

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    worst = 0.0
    edge = [
        ("valid<T, T=100 ragged, mixed past", 2, 100, 256, 4, 2, [0, 30], [77, 100], None),
        ("GQA 28/4, batch of mixed past", 3, 130, 512, 28, 4, [37, 0, 150], [130, 130, 97], None),
        ("a row with valid=0", 2, 16, 128, 4, 4, [10, 0], [16, 0], None),
        ("stale garbage beyond the live region", 2, 70, 256, 8, 4, [20, 5], [70, 40], 3.0e4),
        ("a partial last live tile deep in the buffer, S not a multiple of 128", 1, 300, 4200,
         28, 4, [3900], [290], 3.0e4),
    ]
    for label, b, t, s, h, kh, past, valid, garbage in edge:
        for causal in (True, False):
            args = attention_inputs(gen, b, t, s, h, kh, past, valid, garbage)
            name = f"B2 edge {label}, {'causal' if causal else 'non-causal'}"
            _, got, _, err, ratio, rel = q8_compare(flash, args, causal)
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
            check(within_tol(ratio, rel), f"{name}: max abs {err:.3e} ({ratio:.2f} x the "
                  f"elementwise limit), rel {rel:.3e}")
            for row, n in enumerate(valid):
                pad = got[row, min(n, t):]
                check(pad.numel() == 0 or pad.abs().max().item() == 0.0,
                      f"{name}: padded rows are not exactly 0")
            if garbage is not None:  # NaN beyond the live region changes nothing
                q, k, v, p, n = args
                for row, (pp, nn) in enumerate(zip(past, valid)):
                    k[row, pp + nn:] = float("nan")
                    v[row, pp + nn:] = float("nan")
                again = flash.flash_cached_attention(q, k, v, p, n, causal=causal,
                                                     int8_compute=True)
                check(torch.equal(again, got), f"{name}: stale NaN leaked into the output")
            worst = max(worst, err)
            log(f"[kernels] {name}: q8_prep bit-identical to its plain version; B2 max abs err "
                f"{err:.3e} ({ratio:.2f} x the elementwise limit), rel err {rel:.3e}")

    n = (PX // cfg.latent_downsample) ** 2 + 2
    shapes = [
        ("denoise B=3 (CFG)", 3, n, [prompt_len, 0, prompt_len], [n] * 3, False),
        ("vit-block prefill", 1, vqa["vit_t"], [0], [vqa["vit_valid"]], False),
        ("prefill", 1, prefill_t, [0], [prompt_len], True),
    ]
    results, preps = [], []
    for label, b, t, past, valid, causal in shapes:
        args = attention_inputs(gen, b, t, MAX_KV, 28, 4, past, valid)
        prep, got, want, err, ratio, rel = q8_compare(flash, args, causal)
        check(within_tol(ratio, rel), f"B2 {label}: max abs {err:.3e} ({ratio:.2f} x the "
              f"elementwise limit), rel {rel:.3e}")
        worst = max(worst, err)
        q, k, v, p, vl = args
        q8, k8, v8, qs, ks, vs = prep
        if label.startswith("denoise"):  # negative control: V's scale left out
            blind = flash.flash_q8_plain(q8, k8, v8, qs, ks, torch.ones_like(vs), p, vl,
                                         causal=causal)
            b_err, b_ratio, b_rel = kernel_error(got, blind, valid)
            check(not within_tol(b_ratio, b_rel), "B2: the gate accepts V's scale left out")
            log(f"[kernels] B2 {label}: control without V's scale is rejected: max abs "
                f"{b_err:.3e} ({b_ratio:.1f} x the elementwise limit), rel {b_rel:.3e}")
            del blind
        del got, want
        def call():
            return flash.flash_cached_attention_q8(q8, k8, v8, qs, ks, vs, p, vl, causal=causal)

        def prep_call():
            return flash.q8_prep(q, k, v, p, vl)

        ms, call_ms = device_ms(call, 20), cuda_ms(call, 20, 3)
        prep_ms, prep_call_ms = device_ms(prep_call, 20), cuda_ms(prep_call, 20, 3)
        prep_plain_ms = cuda_ms(lambda: flash.q8_prep_plain(q, k, v, p, vl), 3)
        plain_ms = cuda_ms(lambda: flash.flash_q8_plain(q8, k8, v8, qs, ks, vs, p, vl,
                                                        causal=causal), 2)
        mask = cache_mask(MAX_KV, t, p, vl, causal)
        lib_ms = device_ms(sdpa_call(q, k, v, mask), 5)
        flops, _ = attention_work(past, valid, t, 28, 4, 128, causal)
        bytes_ = (b * t * 28 * 128 * 3 + 2 * sum(pp + min(nn, t) for pp, nn in zip(past, valid))
                  * 4 * 128)
        bms, by = bound_ms_at(flops, bytes_, PEAK_INT8)
        pbytes = prep_bytes(b, t, MAX_KV, 28, 4, past, valid)
        pbms = pbytes / PEAK_BYTES * 1e3
        results.append(dict(shape=label, B=b, T=t, past=past, valid=valid, causal=causal,
                            max_abs_err=err, limit_ratio=ratio, rel_err=rel,
                            device_ms=ms, call_ms=call_ms, prep_ms=prep_ms, plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=bms, bound_by=by, tops=flops / ms / 1e9))
        preps.append(dict(shape=label, B=b, T=t, S=MAX_KV, past=past, valid=valid,
                          device_ms=prep_ms, call_ms=prep_call_ms, plain_ms=prep_plain_ms,
                          bound_ms=pbms, bound_by="bytes", bytes=pbytes,
                          gbps=pbytes / prep_ms / 1e6))
        log(f"[kernels] B2 {label}: T={t} past={past} max abs err {err:.3e} ({ratio:.2f} x "
            f"the elementwise limit), rel err {rel:.3e}; kernel device {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TOP/s), call {call_ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"SDPA in bf16 (another function: no int8) device {lib_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({by})")
        log(f"[kernels] q8_prep {label}: bit-identical to its plain version; device "
            f"{prep_ms:.4f} ms ({pbytes / prep_ms / 1e6:.0f} GB/s of the bytes it must move), "
            f"call {prep_call_ms:.4f} ms, plain {prep_plain_ms:.3f} ms, bound {pbms:.4f} ms "
            f"({pbytes / 1e6:.1f} MB)")
        del args, q, k, v, prep, q8, k8, v8, mask
        torch.cuda.empty_cache()
    return worst, results, preps


# ---------------------------------------------------------------------------
# phases 4-5: the model
# ---------------------------------------------------------------------------


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def live_weights(params, cfg, gen, by_layer=False):
    """Seeded random weights that hide no bug: the gen expert differs from
    the und expert, norms differ from 1, and llm2vae is non-zero (a zero
    velocity head would leave the latent on the noise); the SigLIP tower's
    LayerNorms differ from 1 / 0 and its and the connector's biases from 0.
    In place, `live_rule`'s leaves in this order; by_layer: the gen
    expert's stacked leaves drawn a layer at a time (other weights, a
    layer's slice the only temporary)."""
    rule = live_rule(gen, cfg, by_layer)
    vit, llm = params["vit"], params["llm"]
    order = [(f"vit/{ln}/{k}", t) for ln, tree in (("layers/ln1", vit["layers"]["ln1"]),
                                                     ("layers/ln2", vit["layers"]["ln2"]),
                                                     ("post_ln", vit["post_ln"]))
             for k, t in tree.items()]
    linears = [("vit/patch_embed", vit["patch_embed"]), ("connector/fc1", params["connector"]["fc1"]),
               ("connector/fc2", params["connector"]["fc2"])]
    linears += [(f"vit/layers/{g}/{k}", lin) for g in ("attn", "mlp")
                for k, lin in vit["layers"][g].items()]
    order += [(f"{path}/b", lin["b"]) for path, lin in linears]
    order += [(p, t) for p, t in tree_paths(llm["layers"], "llm/layers")]
    order += [(f"llm/{name}", llm[name]) for name in ("final_norm", "final_norm_gen")]
    order.append(("llm2vae/w", params["llm2vae"]["w"]))
    for path, t in order:
        rule(path, t, inplace=True)


def tree_paths(tree, prefix):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def live_rule(gen, cfg, by_layer=False):
    """live_weights' perturbation of one leaf: (path, leaf, inplace) -> the
    leaf to keep (the leaf itself where none applies; with inplace, the leaf
    itself, changed: a full-width leaf's draw is the only temporary)."""
    vit_lns, vit_biased = ("ln1", "ln2", "post_ln"), ("patch_embed", "attn", "mlp")

    def noise(t, std):
        return torch.randn(t.shape, generator=gen, device=t.device).mul_(std)

    def rule(path, t, inplace=False):
        def put(v):
            return t.copy_(v) if inplace else v.to(t.dtype)

        p = path.split("/")
        if path == "llm2vae/w":
            return put(noise(t, cfg.llm.hidden_size ** -0.5))
        if p[0] == "llm" and p[1] in ("layers", "final_norm", "final_norm_gen"):
            if bool((t == 1).all()):  # a norm weight
                return put(noise(t, 0.05).add_(1))
            if p[2:] and p[2].endswith("_gen"):
                if inplace and by_layer:
                    for z in t:
                        z.add_(noise(z, 0.02).to(z.dtype))
                    return t
                d = noise(t, 0.02).to(t.dtype)
                return t.add_(d) if inplace else t + d
            return t
        if p[0] == "vit" and any(n in p for n in vit_lns):
            return put(noise(t, 0.05).add_(1) if p[-1] == "w" else noise(t, 0.05))
        if p[-1] == "b" and (p[0] == "connector" or
                             p[0] == "vit" and any(n in p for n in vit_biased)):
            return put(noise(t, 0.02))
        return t

    return rule


def live_place(gen, cfg, then=None):
    """`init_bagel_params`' place with `live_rule`, each leaf perturbed
    whole as the init draws it, then kept as `then(path, leaf)` gives it (a
    process's shard): the same weights under every layout and world size."""
    rule = live_rule(gen, cfg)

    def place(path, t):
        t = rule(path, t)
        return then(path, t) if then is not None else t

    return place


def stacked_cache(ctxs):
    from bagel_tpu_torch.models.qwen2 import KVCache

    return KVCache(k=torch.cat([c.cache.k for c in ctxs], dim=1),
                   v=torch.cat([c.cache.v for c in ctxs], dim=1),
                   length=torch.cat([c.cache.length for c in ctxs]))


def prompt_contexts(engine):
    """The three contexts interleave_inference builds for one prompt:
    cond, cfg_text (empty) and cfg_img."""
    ctx = engine.init_context()
    cfg_text, cfg_img = ctx.copy(), ctx.copy()
    ctx = engine.update_context_text(PROMPT, ctx)
    cfg_img = engine.update_context_text(PROMPT, cfg_img)
    return [ctx, cfg_text, cfg_img]


def n_latents(cfg, px):
    return (px // cfg.latent_downsample) ** 2


def gen_block_velocity(engine, ctxs, x1, depth, impl):
    """The velocity of one gen block [start, end, latents x1 at t=0.8] over
    the contexts' caches (batch = len(ctxs)), through `depth` layers."""
    from bagel_tpu_torch.inference.engine import _whole
    from bagel_tpu_torch.models import qwen2
    from bagel_tpu_torch.models.bagel import latent_to_llm

    cfg, layout = engine.cfg, engine.layout
    params = _whole(engine.params, layout, "vae2llm", "time_embed", "llm2vae")
    n = x1.shape[0]
    px = int(round(n ** 0.5)) * cfg.latent_downsample
    cache = stacked_cache(ctxs)
    b = len(ctxs)
    lat_pos = torch.as_tensor(engine._pos_ids(px, px, cfg.latent_downsample,
                                              cfg.max_latent_size), device=DEVICE)
    lat = latent_to_llm(params, cfg, x1, torch.full((n,), 0.8, device=DEVICE), lat_pos)
    tok = qwen2.embed_tokens(params["llm"], engine._boundary_ids(), layout)
    block = torch.cat([tok, lat.to(tok.dtype)])[None].expand(b, n + 2, -1).contiguous()
    pos = torch.tensor([c.rope for c in ctxs], device=DEVICE)[:, None].expand(b, n + 2)
    valid = torch.full((b,), n + 2, dtype=torch.int32, device=DEVICE)
    llm_cfg = dataclasses.replace(cfg.llm, num_hidden_layers=depth)
    hidden, _ = qwen2.llm_extend(params["llm"], llm_cfg, block, pos, cache, valid, und_len=2,
                                 causal=False, update_cache=False, attn_impl=impl, layout=layout)
    head = params["llm2vae"]
    vel = hidden[:, 2:].float() @ head["w"].float() + head["b"].float()
    del hidden
    torch.cuda.empty_cache()
    return vel


def phase_forward(engine, gen):
    """One gen-block forward of the full MoT through the kernel (auto) and
    the dense path, on the same inputs; relative error of the velocity."""
    cfg = engine.cfg
    ctxs = prompt_contexts(engine)
    n = n_latents(cfg, FORWARD_PX)
    x1 = torch.randn((n, cfg.patch_latent_dim), generator=gen, device=DEVICE)
    # depth 1 shows the error one attention leaves; full depth what the
    # random-weight stack makes of it
    for depth, tol in ((1, FORWARD_TOL_1), (cfg.llm.num_hidden_layers, FORWARD_TOL)):
        vel = {impl: gen_block_velocity(engine, ctxs, x1, depth, impl)
               for impl in ("auto", "dense")}
        rel = relative_error(vel["auto"], vel["dense"])
        check(bool(torch.isfinite(vel["auto"]).all()), "forward: non-finite velocity")
        check(rel <= tol, f"forward: depth {depth} velocity rel err {rel:.3e} > {tol}")
        log(f"[forward] {FORWARD_PX} px gen block (T={n + 2}, B={len(ctxs)}), {depth} "
            f"layer(s): kernel vs dense velocity rel err {rel:.3e} (tol {tol})")
        del vel


def vqa_image():
    """The seeded synthetic VQA image: HWC float32 in [-1, 1]."""
    return np.random.default_rng(SEED).uniform(-1, 1, (VQA_PX, VQA_PX, 3)).astype(np.float32)


def vit_block_inputs(engine, image):
    """The padded ViT inputs update_context_image builds for one image:
    (patches [nb, p*p*3], pos [nb], seg [nb], n real patches)."""
    from bagel_tpu_torch.inference.engine import _bucket

    cfg = engine.cfg
    patch = cfg.vit.patch_size
    patches, pos, _, _ = engine._prep_image_tokens(
        engine._crop_to_multiple(image, patch), patch, cfg.vit_max_num_patch_per_side)
    n = patches.shape[0]
    nb = _bucket(n + 2) - 2
    patches_p = np.zeros((nb, patches.shape[1]), np.float32)
    patches_p[:n] = patches
    pos_p = np.zeros(nb, np.int64)
    pos_p[:n] = pos
    seg = np.zeros(nb, np.int32)
    seg[:n] = 1
    return (engine._patches(patches_p), engine._tensor(pos_p, torch.long),
            engine._tensor(seg), n)


def phase_vit_forward(engine):
    """The full-width SigLIP tower + connector on the 980 px image through
    the kernel (auto) and the dense path: relative error over the real
    tokens, at depth 1 and at full depth."""
    from bagel_tpu_torch.models.bagel import encode_vit_tokens

    cfg, params = engine.cfg, engine.params
    patches, pos, seg, n = vit_block_inputs(engine, vqa_image())
    for depth, tol in ((1, VIT_TOL_1), (cfg.vit.num_hidden_layers, VIT_TOL)):
        vcfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, num_hidden_layers=depth))
        out = {impl: encode_vit_tokens(params, vcfg, patches, pos, seg, attn_impl=impl)[:n]
               for impl in ("auto", "dense")}
        rel = relative_error(out["auto"], out["dense"])
        check(bool(torch.isfinite(out["auto"]).all()), "vit forward: non-finite output")
        check(rel <= tol, f"vit forward: depth {depth} rel err {rel:.3e} > {tol}")
        log(f"[forward] SigLIP + connector, {VQA_PX} px ({n} patches in a block of "
            f"{seg.shape[0]}), {depth} layer(s): kernel vs dense rel err {rel:.3e} (tol {tol})")
        del out
        torch.cuda.empty_cache()


def phase_t2i(engine, gen):
    from bagel_tpu_torch.inference import engine as tengine
    from bagel_tpu_torch.models.bagel import unpatchify_latent
    from bagel_tpu_torch.models.vae import vae_decode
    from bagel_tpu_torch.ops import flash
    from bagel_tpu_torch.ops import sparse_flash as sf

    cfg = engine.cfg
    L = cfg.llm.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()

    # the main path, through the user entry point, counted
    flash.flash_cached_attention.launches = 0
    sf.sparse_packed_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine(text=PROMPT, understanding_output=False, image_shapes=(PX, PX),
                 rng=torch.Generator(device=DEVICE).manual_seed(SEED), **CFG)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = flash.flash_cached_attention.launches
    check(sf.sparse_packed_attention.launches == 0, "text-to-image launched B3")
    peak = torch.cuda.max_memory_allocated()
    img = out["image"]
    expected = L * (2 + NUM_TIMESTEPS - 1)
    log(f"[t2i] __call__ {PX} px, {NUM_TIMESTEPS} timesteps: {total_s:.2f} s, kernel "
        f"launches {launches} (expected {L} x (2 prefills + {NUM_TIMESTEPS - 1} forwards) "
        f"= {expected}), peak memory {peak / 2**30:.2f} GiB")
    check(launches == expected, f"launch count {launches} != {expected}")
    check(isinstance(img, np.ndarray) and img.shape == (PX, PX, 3) and img.dtype == np.uint8,
          f"image {getattr(img, 'shape', None)} {getattr(img, 'dtype', None)}")
    check(img.std() > 0, "constant image")

    # the same run's latent: the noise __call__ drew, handed in explicitly
    side = PX // cfg.latent_downsample
    n, pd = side * side, cfg.patch_latent_dim
    noise = torch.randn((n, pd), generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                        device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx, cfg_text, cfg_img = prompt_contexts(engine)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3 / 2
    latent = engine.gen_image((PX, PX), ctx, cfg_text_precontext=cfg_text,
                              cfg_img_precontext=cfg_img, init_noise=noise.cpu().numpy(),
                              return_latent=True, **CFG)
    moved = float(np.abs(latent - noise.cpu().numpy()).mean())
    check(latent.shape == (n, pd) and bool(np.isfinite(latent).all()), "non-finite latent")
    check(moved > 0.05, f"latent stayed on the noise (mean |x0 - x1| = {moved:.3e})")
    z = unpatchify_latent(torch.as_tensor(latent, device=DEVICE), side, side,
                          cfg.latent_patch_size, cfg.latent_channel)[None]
    again = (torch.clamp(vae_decode(engine.params["vae"], cfg.vae, z) * 0.5 + 0.5, 0, 1)
             * 255).to(torch.uint8)[0].cpu().numpy()
    diff = int(np.abs(again.astype(int) - img.astype(int)).max())
    check(diff <= 1, f"__call__ image and decoded latent differ by {diff} levels")
    log(f"[t2i] latent {n}x{pd} finite, mean |x0 - x1| {moved:.4f}; decoded latent matches "
        f"the __call__ image within {diff} level(s)")

    # times of the pieces, on the same contexts
    boundary = engine._boundary_ids()
    lat_pos = torch.as_tensor(engine._pos_ids(PX, PX, cfg.latent_downsample,
                                              cfg.max_latent_size), device=DEVICE)
    x_t = noise[None]
    forward_ms = {}
    for label, ctxs in (("B=3", [ctx, cfg_text, cfg_img]), ("B=1", [ctx])):
        rope = torch.tensor([c.rope for c in ctxs], device=DEVICE)
        flow_v = tengine._make_flow_v(engine.params, cfg, n, 1, len(ctxs), boundary, rope,
                                      stacked_cache(ctxs), lat_pos)
        forward_ms[label] = cuda_ms(lambda: flow_v(x_t, 0.5), 2)
    vae_ms = cuda_ms(lambda: vae_decode(engine.params["vae"], cfg.vae, z), 2)
    log(f"[t2i] prefill {prefill_ms:.1f} ms (host clock, {ctx.kv_len} tokens); denoise "
        f"forward {forward_ms['B=3']:.1f} ms at B=3, {forward_ms['B=1']:.1f} ms at B=1; "
        f"VAE decode {vae_ms:.1f} ms; total __call__ {total_s:.2f} s")
    return dict(launches=launches, total_s=total_s, latent=latent, noise=noise.cpu().numpy(),
                image=img, forward_ms=forward_ms)


def vqa_context(engine, image):
    """The context interleave_inference builds for (image, question) with
    understanding_output=True."""
    ctx = engine.update_context_image(image, engine.init_context(), vae=False, vit=True)
    return engine.update_context_text(QUESTION, ctx)


def first_logits(engine, ctx, impl):
    """The first decode step's logits (bos at the context's rope position)."""
    from bagel_tpu_torch.models import qwen2

    llm, layout = engine.params["llm"], engine.layout
    bos = engine._tensor([engine.new_token_ids["bos_token_id"]], torch.long)
    hidden, _ = qwen2.llm_extend(
        llm, engine.cfg.llm, qwen2.embed_tokens(llm, bos, layout)[None],
        engine._tensor([[ctx.rope]]), ctx.cache, engine._tensor([1]), und_len=1, causal=True,
        update_cache=False, attn_impl=impl, layout=layout)
    return qwen2.lm_logits(llm, hidden[:, 0], layout)


def program_steps(steps: int, chunk: int, max_steps: int = MAX_THINK) -> int:
    """The decode steps the decode program runs for a loop that JAX leaves
    after `steps` steps: whole chunks of min(chunk, max_steps) steps, up to
    the chunk in which the loop left (the later steps of that chunk attend
    with q_valid 0 and change nothing, but launch their kernels). A capture
    runs one more step eagerly first (its warm-up), which the gates count
    apart."""
    n = min(chunk, max_steps)
    return -(-steps // n) * n


def phase_vqa(engine, card):
    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.models import qwen2
    from bagel_tpu_torch.models.bagel import encode_vit_tokens

    cfg = engine.cfg
    L, LV = cfg.llm.num_hidden_layers, cfg.vit.num_hidden_layers
    image = vqa_image()
    torch.cuda.reset_peak_memory_stats()

    # the main path, through the user entry point, counted: each wrapper's
    # eager launches and the launches the decode program's replays made, read
    # from its graph's kernel nodes
    read = counts_reset()
    caps0 = engine.decode.captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine(image=image, text=QUESTION, understanding_output=True,
                 max_think_token_n=MAX_THINK)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts, replayed = read(), read.replayed()
    b1, b3 = counts["b1"], counts["b3"]
    caps = engine.decode.captures - caps0
    peak = torch.cuda.max_memory_allocated()
    answer = out["text"]
    n_tok = len(answer.split())  # MockTokenizer.decode joins ids with spaces
    steps = n_tok + 1 if n_tok < MAX_THINK else MAX_THINK  # the eos step counts
    run = program_steps(steps, engine.decode.chunk)  # the program's whole chunks
    want = L * (2 + caps + run)
    log(f"[vqa] __call__ {VQA_PX} px + {len(QUESTION)}-char question, {MAX_THINK} tokens at "
        f"most: {total_s:.2f} s, answer of {n_tok} tokens, B3 launches {b3} (expected {LV}), "
        f"B1 launches {b1} (expected {L} x (2 prefills + {caps} capture warm-up steps + {run} "
        f"decode steps: {steps} of the loop in chunks of {engine.decode.chunk}) = {want}; "
        f"{replayed['b1']} of them replayed from the graph's nodes, expected {L * run}), peak "
        f"memory {peak / 2**30:.2f} GiB")
    check(out["image"] is None and n_tok > 0, f"empty answer {answer!r}")
    check(b3 == LV, f"B3 launch count {b3} != {LV}")
    check(b1 == want, f"B1 launch count {b1} != {want}")
    check(replayed["b1"] == L * run,
          f"B1 launches by the graph's replays {replayed['b1']} != {L * run}")
    # the same answer again: the decode program's graph is captured now
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = engine(image=image, text=QUESTION, understanding_output=True,
                  max_think_token_n=MAX_THINK)["text"]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(warm == answer, "a second __call__ gave another answer")
    log(f"[vqa] the same __call__ again (its decode replays the captured chunk): {warm_s:.2f} s")

    # the same question through the dense path: the first step's logits and
    # the greedy tokens
    dense = BagelEngine(engine.params, cfg, engine.tokenizer, engine.new_token_ids,
                        max_kv=MAX_KV, device=DEVICE, attn_impl="dense")
    ctx = vqa_context(engine, image)
    ctx_dense = vqa_context(dense, image)
    rel = relative_error(first_logits(engine, ctx, "auto"),
                         first_logits(dense, ctx_dense, "dense"))
    check(rel <= LOGITS_TOL, f"first decode step logits rel err {rel:.3e} > {LOGITS_TOL}")
    toks, toks_dense = answer.split(), dense.gen_text(ctx_dense, max_length=MAX_THINK).split()
    agree = sum(a == b for a, b in zip(toks, toks_dense))
    prefix = next((i for i, (a, b) in enumerate(zip(toks, toks_dense)) if a != b),
                  min(len(toks), len(toks_dense)))
    log(f"[vqa] first decode step logits, kernels vs dense: rel err {rel:.3e} (tol "
        f"{LOGITS_TOL}); greedy tokens: {agree} of {len(toks)} agree position by position, "
        f"the first {prefix} in a row (not gated)")
    del dense, ctx_dense
    torch.cuda.empty_cache()

    # times of the pieces
    patches, pos, seg, n = vit_block_inputs(engine, image)
    vit_ms = cuda_ms(lambda: encode_vit_tokens(engine.params, cfg, patches, pos, seg), 3)
    vit_emb = encode_vit_tokens(engine.params, cfg, patches, pos, seg)
    llm = engine.params["llm"]
    block = torch.cat([qwen2.embed_tokens(llm, engine._boundary_ids()), vit_emb])[None]
    t = block.shape[1]
    empty = engine.init_context()
    block_pos = torch.zeros((1, t), dtype=torch.int32, device=DEVICE)
    prefill_ms = cuda_ms(lambda: qwen2.llm_extend(
        llm, cfg.llm, block, block_pos, empty.cache, engine._tensor([n + 2]), und_len=t,
        causal=False, update_cache=True), 3)
    img_ctx = engine.update_context_image(image, engine.init_context(), vae=False)
    question_ms = cuda_ms(lambda: engine.update_context_text(QUESTION, img_ctx), 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = engine.gen_text(ctx, max_length=MAX_THINK)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    check(again == answer, "gen_text on the same context gave another answer")
    log(f"[vqa] on {card}: SigLIP encode {vit_ms:.1f} ms ({n} patches, {LV} layers); "
        f"vit-block prefill {prefill_ms:.1f} ms (T={t}, {n + 2} valid); question prefill "
        f"{question_ms:.1f} ms ({ctx.kv_len - img_ctx.kv_len} tokens after "
        f"{img_ctx.kv_len}); decode through the decode program "
        f"{decode_ms:.2f} ms per token (host clock, {steps} steps); total __call__ "
        f"{total_s:.2f} s; peak {peak / 2**30:.2f} GiB")
    return dict(b1=b1, b3=b3, answer=answer, total_s=total_s, warm_s=warm_s,
                peak_gib=peak / 2**30, vit_ms=vit_ms,
                prefill_ms=prefill_ms, question_ms=question_ms, decode_ms=decode_ms,
                steps=steps, logits_rel=rel, tokens_agree=agree)


# ---------------------------------------------------------------------------
# phases 6a-6c: TaylorSeer, editing, batched generation
# ---------------------------------------------------------------------------


def counted_call(fn):
    """fn() with every launch count set to 0 just before and read just after:
    (result, seconds, counts, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = counts_reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read(), torch.cuda.max_memory_allocated() / 2**30


def bf16_counts(**kw):
    """The launch counts of a bf16 path: B1 and B3 as given, the rest 0."""
    return dict(dict(b1=0, b2=0, b3=0, b3_bwd=0, b4=0, b5=0, b5_f32=0, quant=0, absmax=0,
                     quant_given=0, prep=0, kv8=0), **kw)


def phase_taylorseer(engine, t2i):
    """TaylorSeer through the engine: with every step full (first_enhance =
    the step count) the latent of phase 5; a 50-timestep 1024 px __call__
    with the default schedule (threshold 3, first_enhance 5), its B1
    launches from the schedule's full steps, against the same image
    without the step cache."""
    from bagel_tpu_torch.inference.taylorseer import taylorseer_schedule

    cfg = engine.cfg
    L = cfg.llm.num_hidden_layers
    ctx, cfg_text, cfg_img = prompt_contexts(engine)
    latent = engine.gen_image((PX, PX), ctx, cfg_text_precontext=cfg_text,
                              cfg_img_precontext=cfg_img, init_noise=t2i["noise"],
                              return_latent=True, enable_taylorseer=True,
                              taylorseer_first_enhance=NUM_TIMESTEPS - 1, **CFG)
    same = bool(np.array_equal(latent, t2i["latent"]))
    rel = float(np.linalg.norm(latent - t2i["latent"]) / np.linalg.norm(t2i["latent"]))
    log(f"[taylorseer] {NUM_TIMESTEPS} timesteps, every step full (first_enhance "
        f"{NUM_TIMESTEPS - 1}): latent vs phase 5's bit for bit: {same} (rel {rel:.3e})")
    check(rel <= 1e-6, f"all-full TaylorSeer latent differs from phase 5's: rel {rel:.3e}")
    del ctx, cfg_text, cfg_img

    steps = dict(CFG, num_timesteps=TS_TIMESTEPS)
    full = int(taylorseer_schedule(TS_TIMESTEPS - 1).is_full.sum())
    runs = {}
    for label, ts in (("taylorseer", True), ("all full", False)):
        out, secs, counts, peak = counted_call(lambda: engine(
            text=PROMPT, understanding_output=False, image_shapes=(PX, PX),
            rng=torch.Generator(device=DEVICE).manual_seed(SEED), enable_taylorseer=ts, **steps))
        forwards = full if ts else TS_TIMESTEPS - 1
        want = bf16_counts(b1=L * (2 + forwards))
        img = out["image"]
        log(f"[taylorseer] __call__ {PX} px, {TS_TIMESTEPS} timesteps, {label}: {secs:.2f} s, "
            f"peak {peak:.2f} GiB, launches {counts} (expected B1 {L} x (2 prefills + "
            f"{forwards} forwards) = {want['b1']})")
        check(counts == want, f"taylorseer ({label}) launch counts {counts} != {want}")
        check(isinstance(img, np.ndarray) and img.shape == (PX, PX, 3) and img.std() > 0,
              f"taylorseer ({label}): not a non-constant {PX} px image")
        runs[label] = dict(s=secs, peak_gib=peak, launches=counts, image=img)
    diff = np.abs(runs["taylorseer"]["image"].astype(int) - runs["all full"]["image"].astype(int))
    log(f"[taylorseer] {TS_TIMESTEPS}-timestep image: {runs['taylorseer']['s']:.2f} s with the "
        f"step cache, {runs['all full']['s']:.2f} s without ({runs['all full']['s'] / runs['taylorseer']['s']:.2f}x); "
        f"the two images differ by {diff.mean():.2f} levels on average, {diff.max()} at most "
        f"(not gated)")
    for r in runs.values():
        del r["image"]
    torch.cuda.empty_cache()
    return dict(all_full_bit_identical=same, all_full_rel=rel, full_forwards=full, **runs)


def edit_image_px():
    """The side of the edit's image after the engine's vae_transform."""
    from bagel_tpu_torch.data.transforms import ImageTransform

    return ImageTransform(*EDIT_TRANSFORM)(np.zeros((VQA_PX, VQA_PX, 3), np.float32)).shape[0]


def edit_contexts(engine, image):
    """The three contexts interleave_inference builds for (image, EDIT) on
    the generation path: cond, cfg_text and cfg_img."""
    ctx = engine.update_context_image(image, engine.init_context())
    cfg_text = ctx.copy()
    ctx = engine.update_context_text(EDIT, ctx)
    return [ctx, cfg_text, engine.update_context_text(EDIT, engine.init_context())]


def phase_edit(engine, card):
    """An edit through __call__ on an engine with a 16384-slot KV buffer over
    the same weights; its three contexts and one gen block's velocity
    through the kernels vs the plain path; vae_encode on the card vs the
    CPU; the pieces' times."""
    from bagel_tpu_torch.data.transforms import ImageTransform
    from bagel_tpu_torch.inference import engine as tengine
    from bagel_tpu_torch.models import qwen2
    from bagel_tpu_torch.models.bagel import encode_vit_tokens, patchify_latent
    from bagel_tpu_torch.models.vae import vae_encode

    cfg = engine.cfg
    L, LV = cfg.llm.num_hidden_layers, cfg.vit.num_hidden_layers
    eng = tengine.BagelEngine(engine.params, cfg, engine.tokenizer, engine.new_token_ids,
                              max_kv=EDIT_MAX_KV, vae_transform=ImageTransform(*EDIT_TRANSFORM),
                              device=DEVICE)
    image = vqa_image()
    px = edit_image_px()
    out, total_s, counts, peak = counted_call(lambda: eng(
        image=image, text=EDIT, understanding_output=False,
        rng=torch.Generator(device=DEVICE).manual_seed(SEED), **CFG))
    want = bf16_counts(b1=L * (4 + NUM_TIMESTEPS - 1), b3=LV)
    img = out["image"]
    log(f"[edit] __call__ {VQA_PX} px image (vae_transform: {px} px) + {len(EDIT)}-char "
        f"instruction, {NUM_TIMESTEPS} timesteps, KV buffer {eng.max_kv}: {total_s:.2f} s, peak "
        f"{peak:.2f} GiB, launches {counts} (expected B1 {L} x (4 prefills + "
        f"{NUM_TIMESTEPS - 1} forwards) = {want['b1']}, B3 {LV})")
    check(counts == want, f"edit launch counts {counts} != {want}")
    check(isinstance(img, np.ndarray) and img.shape == (px, px, 3) and img.dtype == np.uint8
          and img.std() > 0, f"edit image {getattr(img, 'shape', None)} is not a non-constant "
          f"{px} px uint8 image")

    # the contexts through the kernels and through the plain path; one gen
    # block's velocity over them (the plain one row by row: its fp32 scores
    # of all three rows at once would take ~15 GB a tensor)
    crop = eng.vae_transform(image)
    kctx = edit_contexts(eng, crop)
    dense = tengine.BagelEngine(engine.params, cfg, engine.tokenizer, engine.new_token_ids,
                                max_kv=EDIT_MAX_KV, device=DEVICE, attn_impl="dense")
    dctx = edit_contexts(dense, crop)
    check([c.kv_len for c in kctx] == [c.kv_len for c in dctx], "edit contexts' lengths differ")
    n = n_latents(cfg, px)
    x1 = torch.randn((n, cfg.patch_latent_dim), generator=torch.Generator(device=DEVICE)
                     .manual_seed(SEED + 7), device=DEVICE)
    rels = {}
    for depth, tol in ((1, FORWARD_TOL_1), (L, FORWARD_TOL)):
        kern = gen_block_velocity(eng, kctx, x1, depth, "auto")
        plain = torch.cat([gen_block_velocity(dense, [c], x1, depth, "dense") for c in dctx])
        rel = relative_error(kern, plain)
        check(bool(torch.isfinite(kern).all()), "edit: non-finite velocity")
        check(rel <= tol, f"edit: depth {depth} velocity rel err {rel:.3e} > {tol}")
        rels[depth] = rel
        log(f"[edit] gen block (T={n + 2}, B=3, pasts {[c.kv_len for c in kctx]}), {depth} "
            f"layer(s), contexts built at full depth: kernels vs plain velocity rel err "
            f"{rel:.3e} (tol {tol})")
        del kern, plain
    del dense, dctx
    torch.cuda.empty_cache()

    # vae_encode on the card vs the CPU (the fp32 conv path, TF32 off)
    vae_cpu = tree_to(engine.params["vae"], "cpu")
    small = torch.as_tensor(crop[:256, :256].copy())[None]
    z_cpu = vae_encode(vae_cpu, cfg.vae, small, sample=False)
    z_card = vae_encode(engine.params["vae"], cfg.vae, small.to(DEVICE), sample=False).cpu()
    vae_rel = ((z_card - z_cpu).abs().max() / z_cpu.abs().max()).item()
    check(vae_rel <= 1e-4, f"vae_encode on the card vs the CPU: {vae_rel:.3e} > 1e-4")
    log(f"[edit] vae_encode(sample=False), 256 px, card vs CPU: max abs err / max |z| "
        f"{vae_rel:.3e} (tol 1e-4)")
    del vae_cpu

    # the pieces' times
    img_t = eng._tensor(crop, torch.float32)[None]
    gen = torch.Generator(device=DEVICE)
    vae_ms = cuda_ms(lambda: vae_encode(engine.params["vae"], cfg.vae, img_t,
                                        generator=gen.manual_seed(SEED)), 2)
    lat = patchify_latent(vae_encode(engine.params["vae"], cfg.vae, img_t,
                                     generator=gen.manual_seed(SEED))[0], cfg.latent_patch_size)
    lat_pos = eng._tensor(eng._pos_ids(px, px, cfg.latent_downsample, cfg.max_latent_size),
                          torch.long)
    empty = eng.init_context()
    vae_prefill_ms = cuda_ms(lambda: tengine._prefill_vae(
        eng.params, cfg, empty.cache, eng._boundary_ids(), lat, lat_pos, 0,
        eng._tensor([n + 2])), 3)
    vae_ctx = eng.update_context_image(crop, eng.init_context(), vit=False)
    vit_path_ms = cuda_ms(lambda: eng.update_context_image(crop, vae_ctx, vae=False), 2)
    patches, pos, seg, n_vit = vit_block_inputs(eng, crop)
    llm = eng.params["llm"]
    block = torch.cat([qwen2.embed_tokens(llm, eng._boundary_ids()),
                       encode_vit_tokens(eng.params, cfg, patches, pos, seg)])[None]
    block_pos = torch.ones((1, block.shape[1]), dtype=torch.int32, device=DEVICE)
    vit_prefill_ms = cuda_ms(lambda: qwen2.llm_extend(
        llm, cfg.llm, block, block_pos, vae_ctx.cache, eng._tensor([n_vit + 2]),
        und_len=block.shape[1], causal=False, update_cache=True), 3)
    rope = torch.tensor([c.rope for c in kctx], device=DEVICE)
    flow_v = tengine._make_flow_v(eng.params, cfg, n, 1, 3, eng._boundary_ids(), rope,
                                  stacked_cache(kctx), lat_pos)
    x_t = x1[None]
    forward_ms = cuda_ms(lambda: flow_v(x_t, 0.5), 2)
    log(f"[edit] on {card}: vae_encode {vae_ms:.1f} ms ({px} px, fp32); VAE-block prefill "
        f"{vae_prefill_ms:.1f} ms (T={n + 2}); ViT pathway {vit_path_ms:.1f} ms (SigLIP + "
        f"block), of which the ViT-block prefill {vit_prefill_ms:.1f} ms (T={block.shape[1]}, "
        f"{n_vit + 2} valid, past {vae_ctx.kv_len}); denoise forward B=3 {forward_ms:.1f} ms; "
        f"total __call__ {total_s:.2f} s; peak {peak:.2f} GiB")
    del eng, kctx, vae_ctx, empty, block, flow_v
    torch.cuda.empty_cache()
    return dict(launches=counts, total_s=total_s, peak_gib=peak, px=px, velocity_rel=rels,
                vae_card_vs_cpu=vae_rel, vae_encode_ms=vae_ms, vae_prefill_ms=vae_prefill_ms,
                vit_path_ms=vit_path_ms, vit_prefill_ms=vit_prefill_ms, forward_ms=forward_ms)


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def phase_batch(engine, t2i):
    """generate_batch of two prompts (one denoise, six rows a forward); each
    job's latent at J=2 against the same job alone."""
    cfg = engine.cfg
    L = cfg.llm.num_hidden_layers
    J = len(BATCH_PROMPTS)

    def gens():
        return [torch.Generator(device=DEVICE).manual_seed(SEED + 10 + j) for j in range(J)]

    reqs = [dict(text=p, image_shapes=(PX, PX), rng=g, **CFG)
            for p, g in zip(BATCH_PROMPTS, gens())]
    outs, total_s, counts, peak = counted_call(lambda: engine.generate_batch(reqs))
    want = bf16_counts(b1=L * (J + NUM_TIMESTEPS - 1))
    log(f"[batch] generate_batch of {J} prompts, {PX} px, {NUM_TIMESTEPS} timesteps: "
        f"{total_s:.2f} s ({total_s / J:.2f} s per image; alone, phase 5: {t2i['total_s']:.2f} "
        f"s), peak {peak:.2f} GiB, launches {counts} (expected B1 {L} x ({J} prefills + "
        f"{NUM_TIMESTEPS - 1} forwards) = {want['b1']})")
    check(counts == want, f"batch launch counts {counts} != {want}")
    for o in outs:
        img = o["image"]
        check(isinstance(img, np.ndarray) and img.shape == (PX, PX, 3) and img.std() > 0,
              "batch: not a non-constant 1024 px image")

    # the same jobs' latents: batched, then each alone
    n = n_latents(cfg, PX)
    jobs = []
    for p, g in zip(BATCH_PROMPTS, gens()):
        empty = engine.init_context()
        ctx = engine.update_context_text(p, empty)
        noise = torch.randn((n, cfg.patch_latent_dim), generator=g, device=DEVICE)
        jobs.append(dict(ctx=ctx, cfg_text_precontext=empty, cfg_img_precontext=ctx.copy(),
                         init_noise=noise.cpu().numpy()))
    batched = engine.gen_image_batch((PX, PX), jobs, return_latent=True, **CFG)
    rels = []
    for job, got in zip(jobs, batched):
        alone = engine.gen_image_batch((PX, PX), [job], return_latent=True, **CFG)[0]
        rels.append(float(np.linalg.norm(got - alone) / np.linalg.norm(alone)))
    log(f"[batch] latents at J={J} vs each job alone: rel err {rels} (tol {FORWARD_TOL}; bf16 "
        f"GEMMs at {3 * J} and 3 rows may tile differently)")
    check(max(rels) <= FORWARD_TOL, f"batch: J={J} latent rel err {max(rels):.3e} > {FORWARD_TOL}")
    del jobs, batched
    torch.cuda.empty_cache()
    return dict(launches=counts, total_s=total_s, s_per_image=total_s / J,
                alone_s=t2i["total_s"], peak_gib=peak, latent_rel=rels)


# ---------------------------------------------------------------------------
# phases 7-8: quantized serving
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_linears():
    """The quantized linears through their kernels' plain versions: the
    reference path that the kernel path is held against (with
    attn_impl="dense" for the attention)."""
    from bagel_tpu_torch.models import qwen2
    from bagel_tpu_torch.ops import int4_matmul as m4
    from bagel_tpu_torch.ops import int8_matmul as m8

    saved = qwen2.int8_matmul, qwen2.int4_matmul, qwen2.quantize_rows, qwen2.row_absmax
    qwen2.int8_matmul, qwen2.int4_matmul = m8.int8_matmul_plain, m4.int4_matmul_plain
    qwen2.quantize_rows, qwen2.row_absmax = m8.quantize_rows_plain, m8.row_absmax_plain
    try:
        yield
    finally:
        qwen2.int8_matmul, qwen2.int4_matmul, qwen2.quantize_rows, qwen2.row_absmax = saved


@contextlib.contextmanager
def q8_plain_tile(block_k: int):
    """The plain int8 attention at another key tile: an equally valid int8
    attention (the JAX kernel's tile is a tuning choice), the control that
    shows how far the w8a8 stack carries an attention-level difference."""
    from bagel_tpu_torch.models import qwen2
    from bagel_tpu_torch.ops import flash

    saved = qwen2.flash_cached_attention_plain
    qwen2.flash_cached_attention_plain = functools.partial(flash.flash_cached_attention_plain,
                                                           block_k=block_k)
    try:
        yield
    finally:
        qwen2.flash_cached_attention_plain = saved


@contextlib.contextmanager
def flash_int8(on: bool):
    """BAGEL_FLASH_INT8 for one phase (the wrapper reads it at each call)."""
    old = os.environ.get("BAGEL_FLASH_INT8")
    os.environ["BAGEL_FLASH_INT8"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["BAGEL_FLASH_INT8"]
        else:
            os.environ["BAGEL_FLASH_INT8"] = old


def quantized_engine(engine, mode):
    """The engine's weights quantized (one stacked layer at a time on the
    card) and fused, as the JAX package's server does, and w8a8 weights made
    k-major (one stacked leaf at a time); the non-LLM leaves are shared with
    the bf16 tree."""
    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.models.qwen2 import fuse_llm_params
    from bagel_tpu_torch.utils.quant import is_kmajor, quantize_bagel_params, w8a8_kmajor

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_bagel_params(engine.params, mode)
    qparams["llm"] = fuse_llm_params(qparams["llm"], inplace=True)
    if mode == "w8a8":
        w8a8_kmajor(qparams["llm"])
        layers = qparams["llm"]["layers"]
        w8 = [layers[g][n]["w_q8"] for g in ("attn", "attn_gen") for n in ("qkv", "o")]
        w8 += [layers[g][n]["w_q8"] for g in ("mlp", "mlp_gen") for n in ("gate_up", "down")]
        check(all(is_kmajor(t) for t in w8), "w8a8: the fused weights are not all k-major")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in leaves(qparams["llm"]))
    log(f"[{mode}] quantized and fused the LLM in {time.perf_counter() - t0:.1f} s: "
        f"{nbytes / 1e9:.2f} GB (bf16: "
        f"{sum(t.numel() * t.element_size() for t in leaves(engine.params['llm'])) / 1e9:.2f} GB)")
    return BagelEngine(qparams, engine.cfg, engine.tokenizer, engine.new_token_ids,
                       max_kv=MAX_KV, device=DEVICE), nbytes


def counts_reset():
    """Every launch count set to 0: each wrapper's `.launches` (its eager
    launches, a capture's warm-up step included) and the decode programs'
    replayed kernels. Returns read(): each kernel's launches since, eager
    plus replayed, as the graphs' kernel nodes list the replays; and
    read.replayed(), the replayed part alone."""
    from bagel_tpu_torch.inference import decode_program
    from bagel_tpu_torch.ops import flash, int4_matmul, int8_matmul, sparse_flash

    fns = dict(b1=flash.flash_cached_attention, b2=flash.flash_cached_attention_q8,
               b3=sparse_flash.sparse_packed_attention,
               b3_bwd=sparse_flash.sparse_packed_attention_bwd, b4=int4_matmul.int4_matmul,
               b5=int8_matmul.int8_matmul, b5_f32=int8_matmul.int8_matmul_f32,
               quant=int8_matmul.quantize_rows, absmax=int8_matmul.row_absmax,
               quant_given=int8_matmul.quantize_rows_given,
               prep=flash.q8_prep, kv8=flash.flash_decode_kv8)
    for fn in fns.values():
        fn.launches = 0
    decode_program.replayed_kernels.clear()

    def replayed():
        return {k: decode_program.replayed_launches(fn) for k, fn in fns.items()}

    def read():
        return {k: fn.launches + n for (k, fn), n in zip(fns.items(), replayed().values())}

    read.replayed = replayed
    return read


def linear_glue(qeng, rows):
    """One layer's four fused gen-expert w8a8 linears at `rows` tokens: the
    whole `_linear` (the activation quantization pass + B5), B5 alone on the
    same codes and the quantization pass alone (call times)."""
    from bagel_tpu_torch.models import qwen2
    from bagel_tpu_torch.ops import int8_matmul as m8

    layers = qeng.params["llm"]["layers"]
    leaves_ = [layers["attn_gen"]["qkv"], layers["attn_gen"]["o"], layers["mlp_gen"]["gate_up"],
               layers["mlp_gen"]["down"]]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    linear_ms = b5_ms = quant_ms = 0.0
    for stacked in leaves_:
        leaf = {k: v[0] for k, v in stacked.items()}
        x = torch.randn((rows, leaf["w_q8"].shape[0]), generator=gen, device=DEVICE).bfloat16()
        linear_ms += cuda_ms(lambda: qwen2._linear(x, leaf), 5, 1)
        quant_ms += cuda_ms(lambda: m8.quantize_rows(x), 5, 1)
        xq, xs = m8.quantize_rows(x)
        b5_ms += cuda_ms(lambda: m8.int8_matmul(xq, xs, leaf["w_q8"], leaf["scale"],
                                                leaf.get("b")), 5, 1)
        del x, xs, xq
    return dict(linear_ms=linear_ms, b5_ms=b5_ms, quant_ms=quant_ms)


def phase_t2i_w8a8(engine, gen):
    """w8a8 text-to-image through __call__ with BAGEL_FLASH_INT8 on: B5 for
    every linear, B2 for every attention; one gen-block velocity through
    the kernels vs the plain versions, and vs the bf16 engine."""
    from bagel_tpu_torch.inference import engine as tengine
    from bagel_tpu_torch.ops.flash import Q8_BLOCK_K as tile

    cfg = engine.cfg
    L = cfg.llm.num_hidden_layers
    qeng, nbytes = quantized_engine(engine, "w8a8")
    with flash_int8(True):
        torch.cuda.reset_peak_memory_stats()
        read = counts_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = qeng(text=PROMPT, understanding_output=False, image_shapes=(PX, PX),
                   rng=torch.Generator(device=DEVICE).manual_seed(SEED), **CFG)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        counts = read()
        peak = torch.cuda.max_memory_allocated()
        img = out["image"]
        forwards = NUM_TIMESTEPS - 1
        # fused leaves: qkv, o, gate_up, down per expert; a prefill runs the
        # und expert, a gen block both (the 2 boundary tokens take the und one)
        b5 = L * (4 * 2 + 8 * forwards)
        want = bf16_counts(b2=L * (2 + forwards), b5=b5, quant=b5, prep=L * (2 + forwards))
        log(f"[t2i w8a8] __call__ {PX} px, {NUM_TIMESTEPS} timesteps, BAGEL_FLASH_INT8=1: "
            f"{total_s:.2f} s, peak memory {peak / 2**30:.2f} GiB (at most {W8A8_PEAK_GIB}); "
            f"launches {counts} (expected B5 {L} x (4 x 2 prefills + 8 x {forwards} forwards) "
            f"= {b5}, one quantization pass each, B2 {L} x (2 + {forwards}) = {want['b2']} "
            f"and as many q/k/v prep passes, no B1)")
        check(counts == want, f"w8a8 launch counts {counts} != {want}")
        check(peak / 2**30 <= W8A8_PEAK_GIB,
              f"w8a8 peak memory {peak / 2**30:.2f} GiB > {W8A8_PEAK_GIB} GiB")
        check(isinstance(img, np.ndarray) and img.shape == (PX, PX, 3) and img.std() > 0,
              "w8a8 image is not a non-constant 1024 px image")

        # one gen-block velocity, kernel path vs plain path (both w8a8)
        ctxs = prompt_contexts(qeng)
        x1 = torch.randn((n_latents(cfg, FORWARD_PX), cfg.patch_latent_dim), generator=gen,
                         device=DEVICE)
        # Per-token activation quantization turns a small difference into
        # whole code steps wherever a value sits near a half, so the w8a8
        # stack carries an attention's rounding much further than the bf16
        # one does (PR 3's first run: 8.1e-4 at one layer, 1.0e-1 at 28).
        # One layer keeps the bf16 gate; at full depth the kernels must stay
        # as close to the plain path as the plain path at another key tile
        # is to itself (or within the bf16 gate, if that is wider).
        rels, controls = {}, {}
        for depth in (1, L):
            kern = gen_block_velocity(qeng, ctxs, x1, depth, "auto")
            with plain_linears():
                plain = gen_block_velocity(qeng, ctxs, x1, depth, "dense")
                with q8_plain_tile(2 * tile):
                    other = gen_block_velocity(qeng, ctxs, x1, depth, "dense")
            rel, ctrl = relative_error(kern, plain), relative_error(other, plain)
            tol = FORWARD_TOL_1 if depth == 1 else max(FORWARD_TOL, ctrl)
            check(bool(torch.isfinite(kern).all()), "w8a8 forward: non-finite velocity")
            check(rel <= tol, f"w8a8 forward: depth {depth} kernel vs plain rel {rel:.3e} > {tol}")
            rels[depth], controls[depth] = rel, ctrl
            log(f"[t2i w8a8] {FORWARD_PX} px gen block (B=3), {depth} layer(s): kernels vs "
                f"plain versions, velocity rel err {rel:.3e} (tol {tol:.3e}); control, the "
                f"plain path at key tile {2 * tile} vs {tile}: {ctrl:.3e}")
            del plain, other
        quant = kern
        fwd = dict()
        rope = torch.tensor([c.rope for c in ctxs], device=DEVICE)
        side = PX // cfg.latent_downsample
        lat_pos = torch.as_tensor(qeng._pos_ids(PX, PX, cfg.latent_downsample,
                                                cfg.max_latent_size), device=DEVICE)
        noise = torch.randn((1, side * side, cfg.patch_latent_dim), generator=gen, device=DEVICE)
        flow_v = tengine._make_flow_v(qeng.params, cfg, side * side, 1, 3, engine._boundary_ids(),
                                      rope, stacked_cache(ctxs), lat_pos)
        fwd["w8a8"] = cuda_ms(lambda: flow_v(noise, 0.5), 2)
        glue = linear_glue(qeng, side * side * 3)
    del ctxs
    # quantization error: the same forward through the bf16 engine (B1, bf16)
    bctxs = prompt_contexts(engine)
    bf16 = gen_block_velocity(engine, bctxs, x1, L, "auto")
    q_rel = relative_error(quant, bf16)
    log(f"[t2i w8a8] quantization error, w8a8 (B5 + B2) vs bf16 (B1) engine, {FORWARD_PX} px "
        f"gen block at {L} layers: velocity rel err {q_rel:.3e} (reported, not gated); "
        f"denoise forward at {PX} px, B=3: {fwd['w8a8']:.1f} ms; its w8a8 linears, one "
        f"layer: {glue['linear_ms']:.2f} ms; alone, B5 {glue['b5_ms']:.2f} ms and the "
        f"activation quantization pass {glue['quant_ms']:.2f} ms (call times)")
    del qeng, bctxs, bf16, quant
    torch.cuda.empty_cache()
    return dict(launches=counts, total_s=total_s, peak_gib=peak / 2**30, llm_gb=nbytes / 1e9,
                kernel_vs_plain_rel=rels, other_tile_rel=controls, quant_rel=q_rel,
                forward_ms=fwd["w8a8"], linears_one_layer=glue)


def phase_vqa_int4(engine, card):
    """int4 VQA through __call__: B4 for every decode-step linear, B1 and B3
    as on the bf16 path; the first decode step's logits through the kernels
    vs the plain versions; ms per decode token."""
    cfg = engine.cfg
    L, LV = cfg.llm.num_hidden_layers, cfg.vit.num_hidden_layers
    qeng, nbytes = quantized_engine(engine, "int4")
    image = vqa_image()
    with flash_int8(False):
        torch.cuda.reset_peak_memory_stats()
        read = counts_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = qeng(image=image, text=QUESTION, understanding_output=True,
                   max_think_token_n=MAX_THINK)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        counts, replayed = read(), read.replayed()
        caps = qeng.decode.captures  # a new engine: its program's captures are this call's
        peak = torch.cuda.max_memory_allocated()
        answer = out["text"]
        n_tok = len(answer.split())
        steps = n_tok + 1 if n_tok < MAX_THINK else MAX_THINK
        run = program_steps(steps, qeng.decode.chunk)  # the program's whole chunks
        want = bf16_counts(b1=L * (2 + caps + run), b3=LV, b4=L * 4 * (caps + run))
        log(f"[vqa int4] __call__ {VQA_PX} px + question, {MAX_THINK} tokens at most: "
            f"{total_s:.2f} s, answer of {n_tok} tokens, peak memory {peak / 2**30:.2f} GiB; "
            f"launches {counts} (expected B4 {L} x 4 fused linears x ({caps} capture warm-up "
            f"steps + {run} decode steps ({steps} of the loop in chunks of "
            f"{qeng.decode.chunk})) = {want['b4']}, B1 {L} x (2 + {caps} + {run}) = "
            f"{want['b1']}, B3 {LV}); replayed from the graph's nodes: B4 {replayed['b4']}, B1 "
            f"{replayed['b1']} (expected {L * 4 * run}, {L * run})")
        check(out["image"] is None and n_tok > 0, f"int4: empty answer {answer!r}")
        check(counts == want, f"int4 launch counts {counts} != {want}")
        check((replayed["b4"], replayed["b1"]) == (L * 4 * run, L * run),
              f"int4: launches by the graph's replays {replayed} != B4 {L * 4 * run}, "
              f"B1 {L * run}")

        ctx = vqa_context(qeng, image)
        kern = first_logits(qeng, ctx, "auto")
        with plain_linears():
            plain = first_logits(qeng, ctx, "dense")
        rel = relative_error(kern, plain)
        check(bool(torch.isfinite(kern).all()), "int4: non-finite logits")
        check(rel <= LOGITS_TOL, f"int4 first decode step logits rel err {rel:.3e} > {LOGITS_TOL}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = qeng.gen_text(ctx, max_length=MAX_THINK)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / steps
        check(again == answer, "int4: gen_text on the same context gave another answer")
        log(f"[vqa int4] on {card}: first decode step logits, kernels vs plain versions "
            f"(B4 plain, dense attention): rel err {rel:.3e} (tol {LOGITS_TOL}); decode through "
            f"the decode program {decode_ms:.2f} ms per token (host clock, {steps} steps); "
            f"total __call__ "
            f"{total_s:.2f} s")
    del qeng, ctx
    torch.cuda.empty_cache()
    return dict(launches=counts, total_s=total_s, peak_gib=peak / 2**30, llm_gb=nbytes / 1e9,
                logits_rel=rel, decode_ms=decode_ms, steps=steps)


# ---------------------------------------------------------------------------
# phase 9: serving (ServingRuntime + the HTTP server)
# ---------------------------------------------------------------------------


SERVE_VIT_TF = (980, 378)  # ImageTransform(max, min, 14) of the server's chat images
SERVE_VAE_TF = (1024, 512)  # ... and of its edit images (stride 16)


def serve_prompts():
    """The six text prompts: SERVE_PROMPT_CHARS characters of one text."""
    text = ("Describe the scene in detail: the colours, the light, the weather, every object "
            "you can see and where it stands, and what might happen next in this place. ") * 3
    return [text[:n] for n in SERVE_PROMPT_CHARS]


def serve_transforms(cfg):
    from bagel_tpu_torch.data.transforms import ImageTransform

    return (ImageTransform(*SERVE_VAE_TF, cfg.latent_downsample),
            ImageTransform(*SERVE_VIT_TF, cfg.vit.patch_size))


def serve_chats():
    """The 8 chat bodies: two on the VQA image (as 8-bit PNG, the wire
    format), six text-only."""
    from bagel_tpu_torch.serving.server import encode_png

    png = encode_png(np.round((vqa_image() + 1) * 127.5).astype(np.uint8))
    images = [dict(prompt=QUESTION, image=png, max_tokens=SERVE_TOKENS),
              dict(prompt="Which colours dominate this picture, and where?", image=png,
                   max_tokens=SERVE_TOKENS)]
    return images + [dict(prompt=p, max_tokens=SERVE_TOKENS) for p in serve_prompts()]


def serve_admission(cfg, tok):
    """B1's blocks when the runtime admits the eight chats of serve_chats()
    into its 8 slots at once, from the runtime's own plan
    (`ServingRuntime._plan_blocks` over the widths `_request_widths`
    gives): the image round's T and per-row valid (its two images, 0 on
    the text rows), then the text round's."""
    from bagel_tpu_torch.serving.runtime import ServingRuntime
    from bagel_tpu_torch.serving.server import decode_png

    _, vit_tf = serve_transforms(cfg)
    patch = cfg.vit.patch_size
    widths = []
    for body in serve_chats():
        images = [decode_png(body["image"], vit_tf)] if body.get("image") else []
        widths.append(([(im.shape[0] // patch) * (im.shape[1] // patch) for im in images],
                       len(tok.encode(body["prompt"])) + 2))
    (image_t,), text_t, _, _ = ServingRuntime._plan_blocks(widths)
    return dict(image_t=image_t, image_valid=[w[0][0] + 2 if w[0] else 0 for w in widths],
                text_t=text_t, text_valid=[w[1] for w in widths])


def http_call(url, body=None, timeout=900):
    """(status, reply bytes, seconds) of one request; a reply that is not
    200 is returned, not raised."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    return status, raw, time.perf_counter() - t0


def run_serving(engine, label, chats, extra=(), slots=SERVE_SLOTS, speculative=0):
    """A ServingRuntime and the HTTP server on 127.0.0.1 (an ephemeral
    port) in this process; the chats and the extra (path, body) requests
    sent at once from client threads with urllib. Every launch count is set
    to 0 just before the runtime starts and read once every reply is in
    (eager launches, and the decode program's replays read from its graphs'
    nodes).
    Any reply that is not 200, an error event in a stream, or a stats
    counter that disagrees with the replies fails the phase. Both threads
    are stopped before it returns."""
    from concurrent.futures import ThreadPoolExecutor

    from bagel_tpu_torch.serving.runtime import ServingRuntime
    from bagel_tpu_torch.serving.server import BagelServer, serve_in_thread

    rt = ServingRuntime(engine, slots=slots, decode_chunk=SERVE_CHUNK,
                        max_new_default=SERVE_TOKENS, speculative=speculative)
    cache_gib = sum(t.numel() * t.element_size() for t in rt.cache.buffers()
                    if t is not None) / 2**30
    chunk_s = []
    decode_step = rt._decode_step

    def timed_step():  # a chunk on the host clock, the device drained at both ends
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_step()
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)

    rt._decode_step = timed_step
    httpd, thread = serve_in_thread(BagelServer(rt, *serve_transforms(engine.cfg)))
    base = "http://%s:%d" % httpd.server_address[:2]
    requests = [("/v1/chat", body) for body in chats] + list(extra)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        read = counts_reset()
        rt.start()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(requests)) as pool:
            replies = list(pool.map(lambda r: http_call(base + r[0], r[1]), requests))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = read()
        peak = torch.cuda.max_memory_allocated() / 2**30
        status, raw, _ = http_call(base + "/v1/stats")
        check(status == 200, f"serve ({label}): /v1/stats replied {status}")
        stats = json.loads(raw)
    finally:
        httpd.shutdown()
        httpd.server_close()
        rt.stop()
        thread.join(timeout=30)
    check(not thread.is_alive() and rt._thread is None, f"serve ({label}): a thread did not stop")

    answers, stream, gen_s, latency = [], None, None, []
    for (path, body), (status, raw, secs) in zip(requests, replies):
        check(status == 200, f"serve ({label}): {path} replied {status}: {raw[:400]!r}")
        if body.get("stream"):
            events = [json.loads(line) for line in raw.decode().splitlines() if line.strip()]
            check(bool(events) and events[-1].get("done") is True
                  and not any("error" in e for e in events),
                  f"serve ({label}): the stream ended {events[-1:]}")
            stream = events[-1]["text"]
            check("".join(e["text_delta"] for e in events[:-1]) == stream,
                  f"serve ({label}): the stream's deltas do not add up to its text")
            latency.append(secs)
        elif path == "/v1/chat":
            reply = json.loads(raw)
            check("error" not in reply and isinstance(reply.get("text"), str),
                  f"serve ({label}): chat reply {reply}")
            answers.append(reply["text"])
            latency.append(secs)
        else:
            from PIL import Image

            reply = json.loads(raw)
            img = np.asarray(Image.open(io.BytesIO(base64.b64decode(reply["image"]))))
            check(reply["shape"] == [PX, PX] and img.shape == (PX, PX, 3) and img.std() > 0,
                  f"serve ({label}): generate gave {reply['shape']}, not a {PX} px image")
            gen_s = secs
    tokens = [len(a.split()) for a in answers + ([stream] if stream is not None else [])]
    check(all(n <= SERVE_TOKENS for n in tokens),
          f"serve ({label}): an answer is longer than {SERVE_TOKENS} tokens: {tokens}")
    want = dict(chat_done=len(tokens), gen_done=int(gen_s is not None), tokens_out=sum(tokens))
    got = {k: stats[k] for k in want}
    check(got == want, f"serve ({label}): /v1/stats {got} != the replies' {want}")
    decode_s = sum(chunk_s)
    res = dict(label=label, answers=answers, stream=stream, tokens=tokens, launches=counts,
               captures=rt.decode.captures, stats=stats, wall_s=wall, peak_gib=peak,
               cache_gib=cache_gib, gen_s=gen_s,
               chunks=len(chunk_s), chunk_ms_median=1e3 * float(np.median(chunk_s)),
               chunk_ms_max=1e3 * max(chunk_s), latency_s_median=float(np.median(latency)),
               latency_s_max=max(latency), decode_s=decode_s,
               tokens_per_s=sum(tokens) / decode_s,
               tokens_per_forward=stats["tokens_out"] / max(stats["decode_forwards"], 1))
    log(f"[serve] ({label}) {len(requests)} requests in {wall:.2f} s on {slots} slots: "
        f"{sum(tokens)} tokens, {len(chunk_s)} chunks ({res['chunk_ms_median']:.1f} ms median, "
        f"{res['chunk_ms_max']:.1f} max), {stats['decode_forwards']} decode forwards, "
        f"{stats['prefill_blocks']} prefill blocks, {res['tokens_per_s']:.1f} tokens/s over the "
        f"chunks, latency {res['latency_s_median']:.2f} s median / {res['latency_s_max']:.2f} max"
        + (f", generate {gen_s:.2f} s" if gen_s is not None else "")
        + f"; slot cache {cache_gib:.2f} GiB, peak {peak:.2f} GiB; launches {counts} "
          f"({rt.decode.captures} decode program captures, each with a warm-up step)")
    return res


def slot_logits(engine, rows, tamper=None):
    """A slot cache prefilled as the runtime admits `rows` ((prompt, image)
    pairs) in one group, then (the first decode step's logits [B, V], a
    speculative verify block's logits [B, K + 1, V]): the block is each
    row's start token and K seeded draft tokens, read over the cache
    without writing it. `tamper(cache)` may alter the prefilled cache
    first (a control)."""
    from bagel_tpu_torch.models import qwen2
    from bagel_tpu_torch.serving.runtime import Future, ServingRuntime, _ChatRequest

    rt = ServingRuntime(engine, slots=len(rows), decode_chunk=SERVE_CHUNK)
    rt._prefill_rows(list(range(len(rows))),
                     [_ChatRequest(p, im, SERVE_TOKENS, Future()) for p, im in rows])
    if tamper is not None:
        tamper(rt.cache)
    llm, b, k = engine.params["llm"], len(rows), SERVE_SPECULATIVE
    draft = torch.randint(engine.cfg.llm.vocab_size, (b, k), device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(SEED + 11))
    block = torch.cat([engine._tensor([s.next_token for s in rt.slot_state], torch.long)[:, None],
                       draft], dim=1)
    pos = engine._tensor([s.next_pos for s in rt.slot_state])[:, None] + torch.arange(
        k + 1, dtype=torch.int32, device=DEVICE)
    out = []
    for t in (1, k + 1):
        hidden, _ = qwen2.llm_extend(
            llm, engine.cfg.llm, qwen2.embed_tokens(llm, block[:, :t]), pos[:, :t], rt.cache,
            engine._tensor([t] * b), und_len=t, causal=True, update_cache=False,
            attn_impl=engine.attn_impl)
        out.append(qwen2.lm_logits(llm, hidden.reshape(b * t, -1)).reshape(b, t, -1))
    del rt, hidden
    torch.cuda.empty_cache()
    return out[0][:, 0], out[1]


def scales_as_one(row):
    """A control's tamper: one row's int8 K/V scales taken as 1 over its
    live keys in every layer (the codes read unscaled)."""
    def tamper(cache):
        n = int(cache.length[row])
        cache.k_scale[:, row, :n] = 1.0
        cache.v_scale[:, row, :n] = 1.0
    return tamper


def first_difference(a: str, b: str):
    """The index of the first token where two answers differ, or None."""
    ta, tb = a.split(), b.split()
    i = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y), min(len(ta), len(tb)))
    return None if ta == tb else i


def phase_serve(engine, card):
    """Phase 9: the serving path at full width, through the HTTP server.
    (a) the 8 chats, a streaming chat and a 1024 px generate at once, bf16
    slot cache; (b) the 8 chats on a second engine over the same parameter
    tensors with kv_quant=True; (c) the 8 chats with speculative=4; the
    model gate on a slot cache prefilled as the runtime does; each served
    answer against the same request alone through __call__ (not gated);
    one slot against eight."""
    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.serving.server import decode_png

    cfg = engine.cfg
    L = cfg.llm.num_hidden_layers
    LV = cfg.vit.num_hidden_layers
    torch.cuda.empty_cache()
    chats = serve_chats()
    kv_engine = BagelEngine(engine.params, cfg, engine.tokenizer, engine.new_token_ids,
                            max_kv=MAX_KV, device=DEVICE, kv_quant=True)
    extra = [("/v1/chat", dict(prompt=serve_prompts()[2], max_tokens=SERVE_TOKENS, stream=True)),
             ("/v1/generate", dict(prompt=PROMPT, image_size=PX, seed=SEED, **CFG))]

    runs = {}
    a = runs["a"] = run_serving(engine, "a: bf16 cache", chats, extra)
    want = bf16_counts(b1=L * (a["stats"]["prefill_blocks"] + a["stats"]["decode_forwards"]
                               + a["captures"] + 2 + NUM_TIMESTEPS - 1),
                       b3=LV * a["stats"]["vit_passes"])
    check(a["launches"] == want, f"serve (a) launch counts {a['launches']} != {want} (B1 = "
          f"{L} x (prefill blocks + decode forwards + capture warm-up steps + the image's 2 + "
          f"{NUM_TIMESTEPS - 1}), B3 = {LV} x the packed SigLIP passes)")
    b = runs["b"] = run_serving(kv_engine, "b: int8 cache", chats)
    want = bf16_counts(b1=L * b["stats"]["prefill_blocks"], b3=LV * b["stats"]["vit_passes"],
                       kv8=L * (b["stats"]["decode_forwards"] + b["captures"]))
    check(b["launches"] == want, f"serve (b) launch counts {b['launches']} != {want} (B1 at "
          f"T = 1 never; B1-kv8 = {L} x (the decode steps + capture warm-up steps); B3 = {LV} "
          f"x the SigLIP passes)")
    c = runs["c"] = run_serving(engine, f"c: speculative={SERVE_SPECULATIVE}", chats,
                                speculative=SERVE_SPECULATIVE)
    want = bf16_counts(b1=L * (c["stats"]["prefill_blocks"] + c["stats"]["decode_forwards"]
                               + c["captures"]), b3=LV * c["stats"]["vit_passes"])
    check(c["launches"] == want, f"serve (c) launch counts {c['launches']} != {want} (B1 = "
          f"{L} x (prefill blocks + verify forwards + capture warm-up verifies), B3 = {LV} x "
          f"the SigLIP passes)")
    check(all(r["stats"]["vit_passes"] >= 1 for r in runs.values()),
          "serve: a run with two image chats made no packed SigLIP pass")
    one = run_serving(engine, "one slot", chats[2:3], slots=1)
    log(f"[serve] decode tokens/s over the chunks: 8 slots {a['tokens_per_s']:.1f} (bf16 cache), "
        f"{b['tokens_per_s']:.1f} (int8 cache), one slot {one['tokens_per_s']:.1f}; speculative "
        f"{c['tokens_per_forward']:.2f} tokens per verify forward of 8 rows against "
        f"{a['tokens_per_forward']:.2f} per plain step")

    # the model gate: the eight rows prefilled as the runtime admits them,
    # the images center-cropped to SERVE_GATE_PX (the plain path's fp32
    # scores of a 980 px image block at B = 8 would not fit the card)
    _, vit_tf = serve_transforms(cfg)
    rows = []
    for body in chats:
        image = None
        if body.get("image"):
            full = decode_png(body["image"], vit_tf)
            o = (full.shape[0] - SERVE_GATE_PX) // 2
            image = full[o : o + SERVE_GATE_PX, o : o + SERVE_GATE_PX]
        rows.append((body["prompt"], image))
    def engine_at(**kw):  # another engine over the same parameter tensors
        return BagelEngine(engine.params, cfg, engine.tokenizer, engine.new_token_ids,
                           max_kv=MAX_KV, device=DEVICE, **kw)

    kernels, verify = slot_logits(engine, rows)
    plain, verify_plain = slot_logits(engine_at(attn_impl="dense"), rows)
    kv_kernels, kv_verify = slot_logits(kv_engine, rows)
    kv_plain, kv_verify_plain = slot_logits(engine_at(kv_quant=True, attn_impl="dense"), rows)
    control, _ = slot_logits(kv_engine, rows, tamper=scales_as_one(0))
    rels = dict(
        plain=relative_error(kernels, plain),  # bf16 cache: B1's decode pair and blocks
        verify=relative_error(verify, verify_plain),  # B1 at T = K + 1
        kv8_plain=relative_error(kv_kernels, kv_plain),  # int8 cache: B1-kv8
        kv8_verify=relative_error(kv_verify, kv_verify_plain),  # the dequantized prefix
        int8=relative_error(kv_kernels, kernels),
        int8_control=relative_error(control, kernels),
    )
    int8_rows = [relative_error(kv_kernels[i], kernels[i]) for i in range(len(rows))]
    del plain, verify, verify_plain, kv_kernels, kv_verify, kv_plain, kv_verify_plain, control
    # each row against its own single-session context (update_context_image
    # and update_context_text, one row through the same kernels): a slot
    # that took another row's block or rope would be far off
    rel_rows = []
    for i, (prompt, image) in enumerate(rows):
        ctx = engine.init_context()
        if image is not None:
            ctx = engine.update_context_image(image, ctx, vae=False, vit=True)
        ctx = engine.update_context_text(prompt, ctx)
        rel_rows.append(relative_error(kernels[i : i + 1], first_logits(engine, ctx, "auto")))
    log(f"[serve] model gate, an 8-row slot cache prefilled as the runtime does ({SERVE_GATE_PX}"
        f" px images): kernels vs plain rel err of the first decode step's logits "
        f"{rels['plain']:.3e} (bf16 cache), {rels['kv8_plain']:.3e} (int8 cache), of a "
        f"verify block's (T = {SERVE_SPECULATIVE + 1}) {rels['verify']:.3e} (bf16), "
        f"{rels['kv8_verify']:.3e} (int8) (tol {LOGITS_TOL} each); int8 cache vs bf16 cache, "
        f"both through the kernels, {rels['int8']:.3e} (tol {INT8_KV_LOGITS_TOL}; by row "
        f"{', '.join(f'{r:.2e}' for r in int8_rows)}), control with row 0's scales taken as 1 "
        f"{rels['int8_control']:.3e} (must exceed the tol); each row vs its single-session "
        f"context {', '.join(f'{r:.2e}' for r in rel_rows)} (tol {LOGITS_TOL} each)")
    for key in ("plain", "verify", "kv8_plain", "kv8_verify"):
        check(rels[key] <= LOGITS_TOL, f"serve: slot logits ({key}) kernels vs plain rel err "
              f"{rels[key]:.3e} > {LOGITS_TOL}")
    check(rels["int8"] <= INT8_KV_LOGITS_TOL,
          f"serve: int8 vs bf16 slot logits rel err {rels['int8']:.3e} > {INT8_KV_LOGITS_TOL}")
    check(rels["int8_control"] > INT8_KV_LOGITS_TOL,
          f"serve: the int8 gate accepts row 0's scales taken as 1 ({rels['int8_control']:.3e})")
    check(max(rel_rows) <= LOGITS_TOL,
          f"serve: a slot row's logits vs its single session rel err {max(rel_rows):.3e} > "
          f"{LOGITS_TOL}")

    # each served answer against the same request alone (reported)
    alone = []
    for body in chats:
        image = decode_png(body["image"], vit_tf) if body.get("image") else None
        alone.append(engine(image=image, text=body["prompt"], understanding_output=True,
                            max_think_token_n=SERVE_TOKENS)["text"])
    parity = {}
    for key, run in runs.items():
        diffs = [first_difference(got, ref) for got, ref in zip(run["answers"], alone)]
        parity[key] = dict(identical=sum(d is None for d in diffs), of=len(diffs),
                           first_difference=diffs)
        log(f"[serve] ({run['label']}) answers identical to the request alone through "
            f"__call__: {parity[key]['identical']} of {len(diffs)}; first differing token "
            f"{diffs} (not gated: batched bf16 GEMMs may flip near ties)")
    del kv_engine
    torch.cuda.empty_cache()
    summary = {k: {f: v for f, v in r.items() if f not in ("answers", "stream")}
               for k, r in dict(runs, one=one).items()}
    gate = dict(logits_rel=rels, int8_rows_rel=int8_rows, row_logits_rel=rel_rows)
    log(f"[serve] on {card}: " + json.dumps(dict(summary, parity=parity, **gate)))
    return dict(runs=summary, parity=parity, **gate,
                launches={k: runs[k]["launches"] for k in runs})


# ---------------------------------------------------------------------------
# phase 9d: the decode program against the eager loop
# ---------------------------------------------------------------------------


DP_EXIT_STEPS = 20  # the exit gate: 16-step chunks, 12 steps past the exit


@contextlib.contextmanager
def strict_replays():
    """Every replay of a decode program under torch.cuda.set_sync_debug_mode
    ("error"): an operation inside it that syncs with the host raises. Yields
    the count of replays made."""
    from bagel_tpu_torch.inference.decode_program import DecodeProgram

    real = DecodeProgram._replay
    made = [0]

    def strict(self, e):
        torch.cuda.set_sync_debug_mode("error")
        try:
            real(self, e)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        made[0] += 1

    DecodeProgram._replay = strict
    try:
        yield made
    finally:
        DecodeProgram._replay = real


def idle_share(fn, steps: int = 1):
    """The card's idle share while fn() runs, from torch.profiler's kernel
    records: 1 - (the union of the kernels' intervals) / (the first start to
    the last end), with the kernels a step (of `steps`) and the eight that
    took the most device time (µs a step); None if every session recorded
    no kernel."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile_session(attempt) as prof:
            fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.time_range.end > e.time_range.start)
        if spans:
            busy, (lo, hi) = 0.0, spans[0]
            first, last = spans[0][0], max(end for _, end in spans)
            for a, b in spans[1:]:
                if a > hi:
                    busy, lo, hi = busy + hi - lo, a, b
                else:
                    hi = max(hi, b)
            busy += hi - lo
            by_name: dict = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    name = short_name(e.name) if e.name.startswith("_Z") else e.name[:60]
                    by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / steps
            top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
            return dict(idle=1.0 - busy / (last - first), window_us=last - first,
                        kernels_a_step=len(spans) / steps, busy_us_a_step=busy / steps,
                        top_us_a_step=top)
    return None


def served_answers(engine, chats, *, speculative, graph):
    """The 8 chats through a ServingRuntime in this process (no HTTP): the
    answers, the decode chunks' host ms, tokens/s over them, and the
    runtime's program."""
    from bagel_tpu_torch.serving.runtime import ServingRuntime
    from bagel_tpu_torch.serving.server import decode_png

    _, vit_tf = serve_transforms(engine.cfg)
    rt = ServingRuntime(engine, slots=SERVE_SLOTS, decode_chunk=SERVE_CHUNK,
                        max_new_default=SERVE_TOKENS, speculative=speculative, graph=graph)
    chunk_s, step = [], rt._decode_step

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)

    rt._decode_step = timed_step
    rt.start()
    try:
        futs = [rt.submit_chat(b["prompt"], image=decode_png(b["image"], vit_tf)
                               if b.get("image") else None) for b in chats]
        answers = [f.result(timeout=900) for f in futs]
    finally:
        rt.stop()
    tokens = sum(len(a.split()) for a in answers)
    # steady: every slot busy, a 16-step chunk (the fastest: no capture in it)
    return dict(answers=answers, chunks=len(chunk_s), forwards=rt.stats["decode_forwards"],
                chunk_ms_median=1e3 * float(np.median(chunk_s)), chunk_ms_min=1e3 * min(chunk_s),
                chunk_ms_max=1e3 * max(chunk_s),
                tokens_per_s=tokens / sum(chunk_s),
                steady_tokens_per_s=SERVE_SLOTS * SERVE_CHUNK / min(chunk_s), program=rt.decode)


def phase_decode_program(engine, card, vqa):
    """Phase 9d: the decode program (CUDA graphs of chunks of decode steps)
    against the eager loop (graph=False, the same steps without a graph), on
    phase 9's weights:
    - greedy tokens identical for gen_text (one row, 32 tokens, the VQA
      context), and for the 8-slot runtime over a bf16 cache, an int8 cache,
      with speculative=4 and with both (the int8 verify's graphs are keyed
      by its prefix bound: captures and chunk times recorded);
    - the exit: an 8-row slot cache (phase 9's chats prefilled as the
      runtime admits them) decoded for DP_EXIT_STEPS steps with one row
      frozen: tokens and final lengths identical; the control, a program
      whose 4th step attends with the frozen row's q_valid on, fails that
      gate;
    - no replay syncs with the host (set_sync_debug_mode("error"));
    - ms per token at one row and ms per step at 8 slots, eager and
      program, and the program captured without `keep` (the put-back of the
      entries a step past the exit would overwrite); tokens/s at 8 slots;
      capture seconds and graph pool GiB; the card's idle share over a
      16-step decode at 8 slots, eager and program (a torch.profiler
      trace)."""
    from bagel_tpu_torch.inference.decode_program import DecodeProgram
    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.models import qwen2
    from bagel_tpu_torch.serving.runtime import Future, ServingRuntime, _ChatRequest
    from bagel_tpu_torch.serving.server import decode_png

    cfg = engine.cfg
    llm = engine.params["llm"]
    kv_engine = BagelEngine(engine.params, cfg, engine.tokenizer, engine.new_token_ids,
                            max_kv=MAX_KV, device=DEVICE, kv_quant=True)
    res = {}
    with strict_replays() as replays:
        # gen_text, one row
        ctx = vqa_context(engine, vqa_image())
        texts, ms = {}, {}
        for graph in (False, True, True):  # the first program call may capture
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            texts[graph] = engine.gen_text(ctx, max_length=MAX_THINK, graph=graph)
            torch.cuda.synchronize()
            ms[graph] = (time.perf_counter() - t0) * 1e3 / MAX_THINK
        check(texts[True] == texts[False], "decode program: gen_text's tokens differ from the "
              f"eager loop's: {first_difference(texts[True], texts[False])}")
        res["one_row"] = dict(eager_ms_per_token=ms[False], program_ms_per_token=ms[True],
                              tokens=len(texts[True].split()))

        # the 8-slot runtime: bf16, int8, speculative
        chats = serve_chats()
        res["slots"] = {}
        for label, eng, spec in (("bf16", engine, 0), ("int8", kv_engine, 0),
                                 (f"speculative={SERVE_SPECULATIVE}", engine, SERVE_SPECULATIVE),
                                 (f"int8, speculative={SERVE_SPECULATIVE}", kv_engine,
                                  SERVE_SPECULATIVE)):
            runs = {graph: served_answers(eng, chats, speculative=spec, graph=graph)
                    for graph in (True, False)}
            diffs = [first_difference(a, b) for a, b in zip(runs[True]["answers"],
                                                            runs[False]["answers"])]
            check(all(d is None for d in diffs), f"decode program: the runtime's answers "
                  f"({label}) differ from the eager loop's at tokens {diffs}")
            prog = runs[True].pop("program")
            runs[False].pop("program")
            res["slots"][label] = dict(
                program={k: v for k, v in runs[True].items() if k != "answers"},
                eager={k: v for k, v in runs[False].items() if k != "answers"},
                captures=prog.captures, capture_s=prog.capture_s,
                pool_gib=prog.pool_bytes() / 2**30)
            log(f"[decode program] runtime ({label}), 8 slots: answers identical to the eager "
                f"loop's; a {SERVE_CHUNK}-step chunk {runs[True]['chunk_ms_min']:.1f} ms "
                f"(program) vs {runs[False]['chunk_ms_min']:.1f} ms (eager) at best, "
                f"{runs[True]['steady_tokens_per_s']:.1f} vs "
                f"{runs[False]['steady_tokens_per_s']:.1f} tokens/s in such a chunk, "
                f"{runs[True]['tokens_per_s']:.1f} vs {runs[False]['tokens_per_s']:.1f} over all "
                f"chunks (the capture included), {runs[True]['chunks']} chunks, the slowest "
                f"{runs[True]['chunk_ms_max']:.1f} ms; {prog.captures} captures in "
                f"{prog.capture_s:.2f} s, pool {res['slots'][label]['pool_gib']:.3f} GiB")

        # the exit, on an 8-row slot cache prefilled as the runtime admits the chats
        _, vit_tf = serve_transforms(cfg)
        rt = ServingRuntime(engine, slots=SERVE_SLOTS, decode_chunk=SERVE_CHUNK)
        rt._prefill_rows(list(range(SERVE_SLOTS)), [
            _ChatRequest(b["prompt"], decode_png(b["image"], vit_tf) if b.get("image") else None,
                         SERVE_TOKENS, Future()) for b in chats])
        start = engine._tensor([s.next_token for s in rt.slot_state], torch.long)
        pos = engine._tensor([s.next_pos for s in rt.slot_state])
        active = torch.ones(SERVE_SLOTS, dtype=torch.bool, device=DEVICE)
        active[3] = False
        eos = engine.new_token_ids["eos_token_id"]
        prog = DecodeProgram(chunk=SERVE_CHUNK)

        def decode(program, graph, steps=DP_EXIT_STEPS, frozen=active):
            return qwen2.decode_text(llm, cfg.llm, rt.cache, start, pos, max_steps=steps,
                                     eos_id=eos, active=frozen, program=program, graph=graph)

        (t_p, c_p), (t_e, c_e) = decode(prog, True), decode(prog, False)
        def exit_gate(t, c):
            return torch.equal(t, t_e) and torch.equal(c.length, c_e.length)

        check(exit_gate(t_p, c_p), "decode program: tokens or lengths past the exit differ "
              f"from the eager loop's ({c_p.length.tolist()} vs {c_e.length.tolist()})")
        real_step = qwen2.decode_step

        def q_valid_on(params, cfg_, st, col, gen, **kw):  # the control's step
            if col == 3:
                kw["frozen"] = False
            real_step(params, cfg_, st, col, gen, **kw)

        qwen2.decode_step = q_valid_on
        try:
            t_c, c_c = decode(DecodeProgram(chunk=SERVE_CHUNK), True)
        finally:
            qwen2.decode_step = real_step
        check(not exit_gate(t_c, c_c), "decode program: the exit gate accepts a program whose "
              "4th step attends with the frozen row's q_valid on")
        res["exit"] = dict(lengths=c_p.length.tolist(), control_lengths=c_c.length.tolist())
        log(f"[decode program] exit: {DP_EXIT_STEPS} steps in chunks of {SERVE_CHUNK}, row 3 "
            f"frozen: tokens and lengths {c_p.length.tolist()} identical to the eager loop's; "
            f"the control (the 4th step with row 3's q_valid on) gives lengths "
            f"{c_c.length.tolist()} and is rejected")
        del c_p, c_e, c_c

        # ms per step at 8 slots and the idle share, eager and program; and
        # the program captured without `keep` (its steps no longer put back
        # what a step past the exit overwrites: the put-back's cost)
        steps = 2 * SERVE_CHUNK
        all_on = torch.ones(SERVE_SLOTS, dtype=torch.bool, device=DEVICE)
        keepless = DecodeProgram(chunk=SERVE_CHUNK)
        real_extend = qwen2.llm_extend

        def no_keep(*a, **kw):
            kw.pop("keep", None)
            return real_extend(*a, **kw)

        qwen2.llm_extend = no_keep
        try:
            decode(keepless, True, SERVE_CHUNK, all_on)  # its capture
        finally:
            qwen2.llm_extend = real_extend
        step_ms, idle = {}, {}
        for label, p, graph in (("program", prog, True), ("eager", prog, False),
                                ("program without keep", keepless, True)) * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(p, graph, steps, all_on)
            torch.cuda.synchronize()
            step_ms.setdefault(label, []).append((time.perf_counter() - t0) * 1e3 / steps)
        for graph in (True, False):
            idle[graph] = idle_share(lambda: decode(prog, graph, SERVE_CHUNK, all_on),
                                     SERVE_CHUNK)
        res["eight_slots"] = dict(program_ms_per_step=min(step_ms["program"]),
                                  eager_ms_per_step=min(step_ms["eager"]),
                                  no_keep_ms_per_step=min(step_ms["program without keep"]),
                                  program_idle=idle[True], eager_idle=idle[False])
    check(replays[0] > 0, "decode program: no replay ran")
    eng_prog = engine.decode
    res.update(replays=replays[0], vqa_s=vqa["total_s"], vqa_warm_s=vqa["warm_s"],
               engine_captures=eng_prog.captures,
               engine_capture_s=eng_prog.capture_s, engine_pool_gib=eng_prog.pool_bytes() / 2**30)
    fmt = lambda d: "not measured" if d is None else f"{100 * d['idle']:.1f}%"  # noqa: E731
    log(f"[decode program] on {card}: one row {ms[False]:.2f} -> {ms[True]:.2f} ms a token "
        f"(eager -> program); 8 slots {res['eight_slots']['eager_ms_per_step']:.2f} -> "
        f"{res['eight_slots']['program_ms_per_step']:.2f} ms a step (without keep "
        f"{res['eight_slots']['no_keep_ms_per_step']:.2f}), idle share "
        f"{fmt(idle[False])} -> {fmt(idle[True])}; {replays[0]} replays, none synced with the "
        f"host; the engine's program: {eng_prog.captures} captures in {eng_prog.capture_s:.2f} "
        f"s, pool {res['engine_pool_gib']:.3f} GiB; the VQA answer (phase 6) "
        f"{vqa['total_s']:.2f} s with the capture, {vqa['warm_s']:.2f} s after it")
    del rt, kv_engine, prog, keepless
    gc_cuda()
    return res


# ---------------------------------------------------------------------------
# phase 9e: the eval runners over the engine
# ---------------------------------------------------------------------------

EVAL_ROWS = 8  # the VQA rows: all 8 batched, the first EVAL_SOLO alone
EVAL_SOLO = 3  # timed one by one: the median and the spread
EVAL_TEXT_ROWS = 3  # text-to-image rows, timed one by one
EVAL_EDIT_PX = 976  # the edit row's source: kept by the runner's vae transform (stride 16)
EVAL_JUDGE_REPLY = "Consistency: 2\nRealism: 1\nAesthetic Quality: 2"
EVAL_WISCORE = (0.7 * 2 + 0.2 * 1 + 0.1 * 2) / 2.0  # the reply's WiScore, normalized


def eval_root():
    import shutil

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_eval")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    return root


def write_png(path, gen, px):
    from PIL import Image

    arr = torch.randint(0, 256, (px, px, 3), generator=gen, dtype=torch.uint8).numpy()
    Image.fromarray(arr).save(path)


def write_jsonl(path, rows):
    with open(path, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))


@contextlib.contextmanager
def mock_judge():
    """A judge endpoint on 127.0.0.1 that answers every request with
    EVAL_JUDGE_REPLY; BAGEL_JUDGE_URL names it while the block runs."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    calls = []

    class Judge(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            calls.append(len(body["images"]))
            payload = json.dumps({"text": EVAL_JUDGE_REPLY}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Judge)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    old = os.environ.get("BAGEL_JUDGE_URL")
    os.environ["BAGEL_JUDGE_URL"] = f"http://127.0.0.1:{server.server_address[1]}/v1/judge"
    try:
        yield calls
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        if old is None:
            os.environ.pop("BAGEL_JUDGE_URL", None)
        else:
            os.environ["BAGEL_JUDGE_URL"] = old


def png_diff(path, want):
    from PIL import Image

    got = np.asarray(Image.open(path), np.int16)
    if got.shape != want.shape:
        return None
    return int(np.abs(got - want.astype(np.int16)).max())


def answer_steps(text, max_steps=MAX_THINK):
    """The steps of a greedy decode loop that gave `text`: one a token, the
    eos step included, at most max_steps."""
    n = len(text.split())  # MockTokenizer.decode joins ids with spaces
    return n + 1 if n < max_steps else max_steps


def chat_batch_first_logits(engine, images, prompts):
    """The first decode step's logits [B, V] of chat_batch's rows: its
    prefill (one packed SigLIP pass, the image round, the prompts) into the
    decode program's B-row cache, then bos at each row's rope position,
    read over the cache without writing it."""
    from bagel_tpu_torch.models import qwen2

    b, llm = len(prompts), engine.params["llm"]
    row_images = {i: [im] for i, im in enumerate(images)}
    with engine.decode.lock:
        cache = engine.decode.owned_cache(engine.cfg.llm, b, engine.max_kv, engine.kv_dtype,
                                          engine.device)
        rope = {i: 0 for i in range(b)}
        vit_emb, per_img = engine._pack_images(row_images)
        cache = engine._image_rounds(cache, list(range(b)), row_images, vit_emb, per_img, rope)
        ids_rows = {i: engine._prompt_ids(p) for i, p in enumerate(prompts)}
        cache = engine._text_rows(cache, ids_rows, rope)
        bos = engine._tensor([engine.new_token_ids["bos_token_id"]] * b, torch.long)
        hidden, _ = qwen2.llm_extend(
            llm, engine.cfg.llm, qwen2.embed_tokens(llm, bos)[:, None],
            engine._tensor([[rope[i] + len(ids_rows[i])] for i in range(b)]), cache,
            engine._tensor([1] * b), und_len=1, causal=True, update_cache=False,
            attn_impl=engine.attn_impl)
    return qwen2.lm_logits(llm, hidden[:, 0])


def phase_eval(engine, card):
    """Phase 9e: the eval runners (bagel_tpu_torch.eval) over phase 5's
    weights at full width:
    (a) gen_runner.run_gen with the JAX runner's defaults and
        NUM_TIMESTEPS timesteps: EVAL_TEXT_ROWS text rows over phase 5's
        engine, one call each (B1 L x (2 + 7) a row; their median time
        and spread) and an edit row on a seeded 976 px PNG over an engine
        like phase 6b's (16384 KV slots; B1 L x (4 + 7), B3 LV); each PNG
        within one level of a direct __call__ with the same arguments and
        a generator seeded seed + index; a second run_gen over every row
        writes nothing and launches nothing;
    (b) vlm_runner.run_eval on EVAL_ROWS seeded 980 px PNGs with yes/no
        questions: the first EVAL_SOLO alone (batch_size=1), one call and
        one time a row, each answer
        equal to a direct __call__, B3 LV and B1 L x (2 + the capture's
        warm-up steps + the program's decode steps) a row; all of them
        batched (batch_size=EVAL_ROWS, chat_batch): B3 LV (one packed
        SigLIP pass), B1 L x (2 + warm-up steps + decode steps); each
        batched answer against its row's answer alone (reported), and
        each batched row's first decode step logits within LOGITS_TOL of
        its row alone (the nearest other row's reported);
        score_yesno's scores written;
    (c) judge_scorer wise over (a)'s layout through the HTTP judge against
        a mock endpoint: the summary the mock's fixed reply implies;
    (d) gen_runner.main and vlm_runner.main with no --device (so CUDA) on
        the demo weights, one row each: the layout written, B1 launched."""
    from PIL import Image

    from bagel_tpu_torch.data.transforms import ImageTransform, pil_img2rgb
    from bagel_tpu_torch.eval import gen_runner, judge_scorer, vlm_runner
    from bagel_tpu_torch.inference.engine import BagelEngine

    t_phase = time.perf_counter()
    cfg = engine.cfg
    L, LV = cfg.llm.num_hidden_layers, cfg.vit.num_hidden_layers
    root = eval_root()
    gen = torch.Generator().manual_seed(SEED + 9)
    res = {}

    # (a) generation: a text row and an edit row
    write_png(os.path.join(root, "edit_src.png"), gen, EVAL_EDIT_PX)
    rows = [dict(prompt=PROMPT, tag="single_object", category="nature", index=0),
            dict(prompt=EDIT, image="edit_src.png", category="edit", index=1)]
    # more text rows (the same prompt, x_1 seeded seed + index): one image's
    # time is one sample, so the text rows' median and spread are reported
    rows += [dict(rows[0], index=i) for i in range(2, 1 + EVAL_TEXT_ROWS)]
    outdir = os.path.join(root, "gen")
    # the JAX runner's defaults but for the step count (phase 5's)
    args = gen_runner.parse_args(["--metadata", "-", "--outdir", outdir, "--image_root", root,
                                  "--image_size", str(PX), "--num_timesteps",
                                  str(NUM_TIMESTEPS)])
    vae_tf, vit_tf = serve_transforms(cfg)  # build_engine's, with a checkpoint
    edit_eng = BagelEngine(engine.params, cfg, engine.tokenizer, engine.new_token_ids,
                           max_kv=EDIT_MAX_KV, vae_transform=ImageTransform(*EDIT_TRANSFORM),
                           device=DEVICE)
    wants = dict(text=bf16_counts(b1=L * (2 + NUM_TIMESTEPS - 1)),
                 edit=bf16_counts(b1=L * (4 + NUM_TIMESTEPS - 1), b3=LV))
    gen_s, launches, text_s = {}, {}, []
    for row in rows:
        label, eng = ("edit", edit_eng) if row.get("image") else ("text", engine)
        done, secs, counts, peak = counted_call(
            lambda: gen_runner.run_gen(eng, vae_tf, [row], outdir, args))
        check(done == [row["index"]], f"eval gen ({label}): run_gen generated {done}")
        check(counts == wants[label], f"eval gen ({label}) launch counts {counts} != "
              f"{wants[label]}")
        gen_s[label], launches[f"eval_gen_{label}"] = secs, counts
        if label == "text":
            text_s.append(secs)
        image = None
        if row.get("image"):
            image = vae_tf(pil_img2rgb(Image.open(os.path.join(root, row["image"]))))
        direct = eng(image=image, text=row["prompt"], think=False,
                     image_shapes=image.shape[:2] if image is not None else (args.image_size,) * 2,
                     num_timesteps=args.num_timesteps, cfg_text_scale=args.cfg_text_scale,
                     cfg_img_scale=args.cfg_img_scale, cfg_renorm_type=args.cfg_renorm_type,
                     cfg_renorm_min=args.cfg_renorm_min, cfg_interval=(args.cfg_interval_min, 1.0),
                     timestep_shift=args.timestep_shift, enable_taylorseer=False,
                     rng=torch.Generator(device=DEVICE).manual_seed(args.seed + row["index"])
                     )["image"]
        path = os.path.join(outdir, f"{row['index']:05d}", "samples", "0000.png")
        diff = png_diff(path, direct)
        check(diff is not None and diff <= 1, f"eval gen ({label}): the PNG differs from a "
              f"direct __call__ by {diff} levels (shape {direct.shape})")
        check(direct.std() > 0, f"eval gen ({label}): constant image")
        log(f"[eval] run_gen {label} row ({direct.shape[0]} px, {args.num_timesteps} "
            f"timesteps, cfg {args.cfg_text_scale}/{args.cfg_img_scale}): {secs:.2f} s, peak "
            f"{peak:.2f} GiB, launches {counts} (expected {wants[label]}); the PNG within "
            f"{diff} level(s) of a direct __call__ with a generator seeded "
            f"{args.seed + row['index']}")
    gen_s.update(text=float(np.median(text_s)), text_rows=text_s)
    log(f"[eval] run_gen text rows one by one: {', '.join(f'{t:.3f}' for t in text_s)} s; "
        f"median {gen_s['text']:.3f} s, spread {max(text_s) - min(text_s):.3f} s")
    again, _, counts, _ = counted_call(
        lambda: gen_runner.run_gen(engine, vae_tf, rows, outdir, args)
        + gen_runner.run_gen(edit_eng, vae_tf, rows, outdir, args))
    check(again == [] and counts == bf16_counts(),
          f"eval gen: the resumed run generated {again}, launches {counts}")
    layout = sorted(os.path.relpath(os.path.join(d, f), outdir)
                    for d, _, fs in os.walk(outdir) for f in fs)
    check(layout == sorted(f"{r['index']:05d}/{f}" for r in rows
                           for f in ("metadata.jsonl", "samples/0000.png")),
          f"eval gen: layout {layout}")
    log(f"[eval] run_gen again over every row: nothing generated, no launch; layout {layout}")
    del edit_eng
    gc_cuda()

    # (b) understanding: alone, then batched
    vqa_rows = []
    for i in range(EVAL_ROWS):
        write_png(os.path.join(root, f"vqa{i}.png"), gen, VQA_PX)
        colour = ("red", "green", "blue", "white")[i % 4]
        vqa_rows.append(dict(image=f"vqa{i}.png", question=f"Is the main object {colour}? "
                             "Answer yes or no.", answer=("yes", "no")[i % 2], index=i))
    chunk = engine.decode.chunk
    solo, solo_rows_s, alone_counts, caps, runs = [], [], bf16_counts(), 0, 0
    for row in vqa_rows[:EVAL_SOLO]:
        caps0 = engine.decode.captures
        out, secs, counts, _ = counted_call(lambda: vlm_runner.run_eval(
            engine, vit_tf, [row], root, MAX_THINK, False, 1))
        caps_row = engine.decode.captures - caps0
        runs_row = program_steps(answer_steps(out[0]["prediction"]), chunk)
        want = bf16_counts(b1=L * (2 + caps_row + runs_row), b3=LV)
        check(counts == want, f"eval vqa alone (row {row['index']}): launch counts {counts} "
              f"!= {want}")
        solo += out
        solo_rows_s.append(secs)
        alone_counts = {k: alone_counts[k] + counts[k] for k in counts}
        caps, runs = caps + caps_row, runs + runs_row
    solo_s = sum(solo_rows_s)
    launches["eval_vqa_alone"] = alone_counts
    images = [vit_tf(pil_img2rgb(Image.open(os.path.join(root, row["image"]))))
              for row in vqa_rows]
    direct = [engine(image=img, text=row["question"], understanding_output=True,
                     max_think_token_n=MAX_THINK)["text"] for img, row in zip(images, vqa_rows)]
    same = [r["prediction"] == d for r, d in zip(solo, direct)]
    check(all(same), f"eval vqa alone: run_eval's answers differ from a direct __call__ "
          f"({[first_difference(r['prediction'], d) for r, d in zip(solo, direct)]})")
    check(all(r["prediction"] for r in solo), "eval vqa alone: an empty answer")
    log(f"[eval] run_eval batch_size=1, {EVAL_SOLO} rows of {VQA_PX} px one by one, "
        f"{MAX_THINK} tokens at most: {', '.join(f'{t:.3f}' for t in solo_rows_s)} s (median "
        f"{float(np.median(solo_rows_s)):.3f} s, spread "
        f"{max(solo_rows_s) - min(solo_rows_s):.3f} s), launches {alone_counts} (expected B3 "
        f"{LV} x {EVAL_SOLO}, B1 {L} x (2 x {EVAL_SOLO} prefills + {caps} capture warm-up "
        f"steps + {runs} decode steps)); each answer equal to a direct __call__")

    caps0 = engine.decode.captures
    batched, batch_s, counts, peak = counted_call(lambda: vlm_runner.run_eval(
        engine, vit_tf, vqa_rows, root, MAX_THINK, False, EVAL_ROWS))
    caps = engine.decode.captures - caps0
    steps = max(answer_steps(r["prediction"]) for r in batched)
    run = program_steps(steps, chunk)
    want = bf16_counts(b1=L * (2 + caps + run), b3=LV)
    check(counts == want, f"eval vqa batched: launch counts {counts} != {want}")
    check([r["index"] for r in batched] == list(range(EVAL_ROWS))
          and all(r["prediction"] for r in batched), "eval vqa batched: rows or answers missing")
    launches["eval_vqa_batched"] = counts
    agree = [first_difference(r["prediction"], d) for r, d in zip(batched, direct)]
    # the answers may part after a near-tie, but the first decode step's
    # logits of each batched row must agree with its row alone, as the serve
    # phase holds its slot rows against their sessions; the nearest other
    # row's distance is reported beside them
    questions = [row["question"] for row in vqa_rows]
    batch_logits = chat_batch_first_logits(engine, images, questions)
    alone_logits = torch.cat([first_logits(engine, engine.update_context_text(
        q, engine.update_context_image(img, engine.init_context(), vae=False, vit=True)),
        "auto") for img, q in zip(images, questions)])
    row_rel = [relative_error(batch_logits[i], alone_logits[i]) for i in range(EVAL_ROWS)]
    cross_rel = min(relative_error(batch_logits[i], alone_logits[j])
                    for i in range(EVAL_ROWS) for j in range(EVAL_ROWS) if i != j)
    flips = {i: float(batch_logits[i].max() - batch_logits[i, alone_logits[i].argmax()])
             for i in range(EVAL_ROWS) if batch_logits[i].argmax() != alone_logits[i].argmax()}
    check(max(row_rel) <= LOGITS_TOL, f"eval vqa batched: a row's first-step logits vs its "
          f"row alone rel err {max(row_rel):.3e} > {LOGITS_TOL}")
    log(f"[eval] first decode step's logits, each batched row vs its row alone (both through "
        f"the kernels): rel err {', '.join(f'{r:.2e}' for r in row_rel)} (tol {LOGITS_TOL}); "
        f"nearest other row {cross_rel:.3e} (not gated); rows whose first token differs, with the batched "
        f"logit margin of its token over the alone one's: {flips}")
    del batch_logits, alone_logits
    log(f"[eval] run_eval batch_size={EVAL_ROWS} (chat_batch, the decode program): "
        f"{batch_s:.2f} s, peak {peak:.2f} GiB, launches {counts} (expected B3 {LV}, B1 {L} x "
        f"(2 prefill rounds + {caps} capture warm-up steps + {run} decode steps: {steps} of "
        f"the loop)); each answer against its row alone, the first differing token (None: "
        f"identical): {agree} (not gated)")
    scores = vlm_runner.SCORERS["yesno"](batched)
    with open(os.path.join(root, "vqa.jsonl.scores.json"), "w") as f:
        json.dump(scores, f, indent=2)
    check(set(scores) >= {"accuracy", "f1", "unknown_rate"}, f"score_yesno gave {scores}")
    log(f"[eval] score_yesno over the batched answers: {scores}")

    # (c) the judged flow over (a)'s layout
    with mock_judge() as calls:
        judge_scorer.main(["wise", "--results_dir", outdir, "--judge",
                           "bagel_tpu_torch.eval.http_judge:judge", "--out",
                           os.path.join(root, "wise")])
    with open(os.path.join(root, "wise.summary.json")) as f:
        summary = json.load(f)
    want_summary = {"categories": {"nature": EVAL_WISCORE, "edit": EVAL_WISCORE},
                    "overall": EVAL_WISCORE}
    ok = (calls == [1] * len(rows) and abs(summary["overall"] - EVAL_WISCORE) < 1e-9
          and all(abs(summary["categories"][k] - v) < 1e-9
                  for k, v in want_summary["categories"].items()))
    check(ok, f"eval judge: summary {summary}, judge calls {calls}, expected {want_summary}")
    log(f"[eval] judge_scorer wise over the run_gen layout against a mock judge on 127.0.0.1: "
        f"{len(calls)} calls, summary {summary}")

    # (d) the command lines, no --device (CUDA), on the demo weights
    write_png(os.path.join(root, "cli.png"), gen, 28)
    write_jsonl(os.path.join(root, "cli_gen.jsonl"), [dict(prompt="a red cube")])
    write_jsonl(os.path.join(root, "cli_vqa.jsonl"), [dict(image="cli.png",
                                                           question="is it red?",
                                                           answer="yes")])
    cli = {}
    for label, fn, argv in (
            ("gen_runner", gen_runner.main,
             ["--metadata", os.path.join(root, "cli_gen.jsonl"), "--outdir",
              os.path.join(root, "cli_gen"), "--image_size", "32", "--num_timesteps", "3"]),
            ("vlm_runner", vlm_runner.main,
             ["--data", os.path.join(root, "cli_vqa.jsonl"), "--image_root", root, "--out",
              os.path.join(root, "cli_vqa.jsonl.out"), "--max_length", "8", "--score",
              "yesno"])):
        _, secs, counts, _ = counted_call(lambda: fn(argv))
        cli[label] = dict(s=secs, launches=counts)
        check(counts["b1"] > 0, f"eval {label} on the card: B1 never launched ({counts})")
        log(f"[eval] {label}.main with no --device on the demo weights: {secs:.2f} s, "
            f"launches {counts}")
    check(os.path.exists(os.path.join(root, "cli_gen", "00000", "samples", "0000.png"))
          and os.path.exists(os.path.join(root, "cli_gen", "00000", "metadata.jsonl")),
          "eval gen_runner.main wrote no GenEval layout")
    with open(os.path.join(root, "cli_vqa.jsonl.out")) as f:
        cli_rows = [json.loads(x) for x in f]
    check(len(cli_rows) == 1 and cli_rows[0]["prediction"] and
          os.path.exists(os.path.join(root, "cli_vqa.jsonl.out.scores.json")),
          f"eval vlm_runner.main wrote {cli_rows}")
    launches["eval_cli"] = {k: cli["gen_runner"]["launches"][k] + cli["vlm_runner"]["launches"][k]
                            for k in cli["gen_runner"]["launches"]}
    gc_cuda()

    wall = time.perf_counter() - t_phase
    res.update(launches=launches, gen_s=gen_s, vqa_alone_s_per_answer=solo_s / EVAL_SOLO,
               vqa_alone_s_rows=solo_rows_s, vqa_batched_s_per_answer=batch_s / EVAL_ROWS,
               judge_summary=summary, yesno=scores, batched_vs_alone=agree,
               batched_logits_rel=row_rel, batched_logits_cross_rel=cross_rel,
               cli=cli, wall_s=wall)
    log(f"[eval] on {card}: {gen_s['text']:.2f} s per text-to-image eval image (median of "
        f"{EVAL_TEXT_ROWS}) and "
        f"{gen_s['edit']:.2f} s per edit image ({args.num_timesteps} timesteps); "
        f"{solo_s / EVAL_SOLO:.2f} s per eval answer alone, {batch_s / EVAL_ROWS:.3f} s per "
        f"answer batched by {EVAL_ROWS} ({MAX_THINK} tokens at most); phase wall time "
        f"{wall:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 10: training at full width, depth TRAIN_LAYERS
# ---------------------------------------------------------------------------

# Full depth does not fit one card: 28 layers' training state (fp32 weights,
# gradients, two Adam moments, EMA: 20 bytes a parameter) is ~280 GB, and
# sharding it waits for ROADMAP A, parallelism. So the trainer runs every width of
# BAGEL-7B-MoT + SigLIP so400m at TRAIN_LAYERS LLM layers (SigLIP keeps its
# 27) and packs TRAIN_TOKENS tokens a step, the reference's 32768 (max
# 36864): at 16384 the step peaked at 59.5 GiB, at 24576 at 62.8 GiB
# (NVIDIA H100 80GB HBM3), so the length was raised to the reference's.
TRAIN_PRESET = "7b"
TRAIN_LAYERS = 2
TRAIN_TOKENS = (32768, 36864)  # --expected_num_tokens, --max_num_tokens
TRAIN_STEPS = 4  # steps of the timed driver run (the first warms up) and of the fixed batch
GRAD_S = 2048  # B3's gradient check: the packed length
# the model gate, --sparse_block (B3 + its backward kernels) against
# --attn_chunk 512 (plain) on one batch and the same weights, both under
# bf16 autocast: the loss within TRAIN_LOSS_TOL relative, each top-level
# group's gradient within TRAIN_GRAD_TOL (||g_sparse - g_chunk|| / ||g_chunk||)
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_TOL = 5e-2
# B3's stored logsumexp against the plain one (fp32 scores of the same bf16
# inputs): the kernel sums exp2 on the SFU (~2 ulp) in another order; 1e-4
# is ~100x what that gives on values of a few units
LSE_ATOL = 1e-4
# the learning rate of the fixed batch and the driver runs. With warmup 1
# the first Adam update (eps 1e-15) moves every weight by about lr, along
# its gradient's sign: at width 3584 a layer's outputs then move by ~width x
# lr of their size, coherently. The fixed batch's loss rose for a step by
# 5x at lr 1e-4 and by 16% at 2e-5 (NVIDIA H100 80GB HBM3, 700 W); the
# reference warms up over 2000 steps
TRAIN_LR = 1e-6
TRAIN_PX = 512  # the corpus's images (VAE: 32 x 32 latent patches; ViT: 35 x 35 patches)


def grad_ids(s):
    """The training predicate on s tokens: three documents, each causal text
    around a full and a noise split, the second with text after its noise
    split (so that the noise predicate matters), then 148 padding rows."""
    doc = segment_ids([600, 700, s - 1448], s)
    fan = torch.full((s,), -1, dtype=torch.int32, device=DEVICE)
    noise = fan.clone()
    for sid, (a, b, is_noise) in enumerate(((200, 400, False), (400, 600, True),
                                            (700, 900, True), (1000, 1300, False),
                                            (1500, 1700, False), (1700, 1900, True))):
        fan[a:b] = sid
        if is_noise:
            noise[a:b] = sid
    return doc, fan, noise


def grad_errors(got, want, rows):
    """[(max abs, elementwise limit ratio, norm-relative)] of dq, dk, dv over
    the rows that take part (document != 0)."""
    return [sparse_error(g, w, rows) for g, w in zip(got, want)]


def grad_gate(got, want, rows):
    """(grad_errors, whether dq, dk and dv all pass B3's gate)."""
    errs = grad_errors(got, want, rows)
    return errs, all(within_tol(r, rel) for _, r, rel in errs)


def fmt_errs(errs):
    return ", ".join(f"{n} max abs {e[0]:.3e} ({e[1]:.2f} x the limit) rel {e[2]:.3e}"
                     for n, e in zip(("dq", "dk", "dv"), errs))


def phase_sparse_grad():
    """10a: B3's gradient on the card at S = GRAD_S: the Function (the
    kernel forward with its logsumexp, then the backward kernels) against
    the plain version's autograd, and the backward kernels against their
    plain twin fed the kernel's own lse, both under B3's gate; the forward's
    output bit-identical with and without lse, the lse against the plain
    one; stale NaN in padding rows changes no gradient; two negative
    controls (the noise predicate dropped, lse shifted by 1)."""
    from bagel_tpu_torch.ops import sparse_flash as sf

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    ids = grad_ids(GRAD_S)
    tables = sf.kernel_tables(*ids)
    rows = []
    for h, kh, d in ((28, 4, 128), (16, 16, 72)):
        label = f"B3 gradient S={GRAD_S} H={h} KH={kh} D={d}"
        q, k, v = sparse_inputs(gen, GRAD_S, h, kh, d)
        g = torch.randn(q.shape, generator=gen, device=DEVICE).bfloat16()

        def grads(fn, qkv, meta=ids):
            leaves_ = [t.detach().clone().requires_grad_() for t in qkv]
            out = fn(*leaves_, *meta)
            return out.detach(), torch.autograd.grad(out, leaves_, g)

        counts = counts_reset()
        _, got = grads(sf.sparse_packed_attention_train, (q, k, v))
        launched = counts()
        check(launched["b3"] == 1 and launched["b3_bwd"] == 1,
              f"{label}: the Function launched B3 {launched['b3']} and its backward "
              f"{launched['b3_bwd']} times, expected 1 and 1")
        out = sf.sparse_packed_attention(q, k, v, *ids)
        out_lse, lse, out_lo = sf.sparse_packed_attention(q, k, v, *ids, for_backward=True)
        check(torch.equal(out_lse, out), f"{label}: the forward's output changes when it "
                                         f"stores lse and the residual")
        _, plain_lse, _ = sf.sparse_packed_attention_plain(q, k, v, *ids, for_backward=True)
        seen = torch.isfinite(plain_lse)
        lse_err = (lse[seen] - plain_lse[seen]).abs().max().item()
        check(lse_err <= LSE_ATOL and bool(torch.isposinf(lse[~seen]).all()),
              f"{label}: lse vs plain max abs {lse_err:.3e} (limit {LSE_ATOL}), or a row with "
              f"no visible key lacks the +inf sentinel")
        check(all(torch.isfinite(t).all() for t in got), f"{label}: non-finite gradient")
        _, want = grads(sf.sparse_packed_attention_plain, (q, k, v))
        errs, ok = grad_gate(got, want, ids[0])
        check(ok, f"{label}: kernel vs plain autograd {fmt_errs(errs)}")
        twin = sf.sparse_packed_attention_bwd_plain(q, k, v, out, lse, g, ids, d**-0.5,
                                                    out_lo=out_lo)
        twin_errs, twin_ok = grad_gate(got, twin, ids[0])
        check(twin_ok, f"{label}: kernel vs its plain twin on the kernel's lse "
                       f"{fmt_errs(twin_errs)}")
        # NaN in the rows no query sees (padding) changes no gradient
        dead = ids[0] == 0
        stale = [t.clone() for t in (q, k, v)]
        for t in stale:
            t[dead] = float("nan")
        _, again = grads(sf.sparse_packed_attention_train, stale)
        check(all(torch.equal(a, b) for a, b in zip(again, got)),
              f"{label}: stale NaN in dead rows leaked into the gradient")
        # controls: the noise predicate dropped, and lse shifted by 1 (every
        # P scaled by 1/e), must each fail the gate
        _, blind = grads(sf.sparse_packed_attention_train, (q, k, v),
                         (ids[0], ids[1], torch.full_like(ids[2], -1)))
        blind_errs, blind_ok = grad_gate(blind, want, ids[0])
        check(not blind_ok, f"{label}: the gate accepts a gradient without the noise predicate")
        shifted = sf.sparse_packed_attention_bwd(q, k, v, out, lse + 1, g, ids, out_lo=out_lo)
        shift_errs, shift_ok = grad_gate(shifted, twin, ids[0])
        check(not shift_ok, f"{label}: the gate accepts the backward on lse + 1")

        def bwd():
            return sf.sparse_packed_attention_bwd(q, k, v, out, lse, g, ids, tables=tables,
                                                  out_lo=out_lo)

        dev_ms, call_ms = device_ms(bwd, 5), cuda_ms(bwd, 5)
        plain_ms = cuda_ms(lambda: sf.sparse_packed_attention_bwd_plain(
            q, k, v, out, lse, g, ids, d**-0.5, out_lo=out_lo), 2)
        row = dict(shape=f"S={GRAD_S}, H={h}, KH={kh}, D={d}",
                   **{f"{n}_max_abs_err": e[0] for n, e in zip(("dq", "dk", "dv"), errs)},
                   **{f"{n}_limit_ratio": e[1] for n, e in zip(("dq", "dk", "dv"), errs)},
                   **{f"{n}_rel_err": e[2] for n, e in zip(("dq", "dk", "dv"), errs)},
                   twin_rel_err=[e[2] for e in twin_errs],
                   twin_limit_ratio=[e[1] for e in twin_errs], lse_max_abs_err=lse_err,
                   control_rel_err=[e[2] for e in blind_errs],
                   lse_shift_control_rel_err=[e[2] for e in shift_errs],
                   backward_device_ms=dev_ms, backward_call_ms=call_ms,
                   backward_plain_ms=plain_ms)
        rows.append(row)
        log(f"[train] {label}: the Function launched B3 and its backward once each; forward "
            f"bit-identical with lse stored, lse vs plain max abs {lse_err:.3e}; vs plain "
            f"autograd {fmt_errs(errs)}; vs the plain twin on the kernel's lse "
            f"{fmt_errs(twin_errs)}; stale NaN in dead rows changes nothing; controls rejected: "
            f"without the noise predicate rel {', '.join(f'{e[2]:.3e}' for e in blind_errs)}, "
            f"lse + 1 rel {', '.join(f'{e[2]:.3e}' for e in shift_errs)}; backward kernels "
            f"device {dev_ms:.3f} ms, call {call_ms:.3f} ms, plain twin {plain_ms:.2f} ms")
        del q, k, v, g, out, out_lo, twin, want, got
    torch.cuda.empty_cache()
    return rows


def backward_at_shape(label, q, k, v, ids, tables, gen):
    """B3's backward kernels at a training shape: against the VJP of the
    chunked recompute (JAX's backward, and the port's before these
    kernels), gated norm-relative (KERNEL_REL each of dq, dk, dv), with the
    elementwise tail reported as the forward's is; their device and call
    time, the bound, the plain twin's and the recompute's time, SDPA's
    backward in turns with the kernels (call times), peak memory."""
    from bagel_tpu_torch.ops import sparse_flash as sf
    from bagel_tpu_torch.ops.attention import train_packed_mask
    from bagel_tpu_torch.ops.chunked import chunked_packed_attention

    s, h, d = q.shape
    kh = k.shape[1]
    g = torch.randn(q.shape, generator=gen, device=DEVICE).bfloat16()
    out, lse, out_lo = sf.sparse_packed_attention(q, k, v, *ids, tables=tables,
                                                  for_backward=True)
    check(torch.equal(out, sf.sparse_packed_attention(q, k, v, *ids, tables=tables)),
          f"{label}: the forward's output changes when it stores lse and the residual")

    def bwd():
        return sf.sparse_packed_attention_bwd(q, k, v, out, lse, g, ids, tables=tables,
                                              out_lo=out_lo)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = bwd()
    torch.cuda.synchronize()
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    check(all(torch.isfinite(t).all() for t in got), f"{label}: non-finite gradient")
    # the reference: the chunked recompute's VJP, in fp32 sums over bf16 inputs
    chunk = math.gcd(s, sf.BWD_CHUNK)
    leaves_ = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref_out = chunked_packed_attention(*leaves_, *ids, chunk=chunk)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    want = torch.autograd.grad(ref_out, leaves_, g, retain_graph=True)
    torch.cuda.synchronize()
    recompute_peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    recompute_ms = cuda_ms(lambda: torch.autograd.grad(ref_out, leaves_, g, retain_graph=True),
                           1, 0)
    del ref_out, leaves_
    errs = grad_errors(got, want, ids[0])
    rows = ids[0] != 0
    over = []
    for a, b in zip(got, want):
        a, b = a[rows].float(), b[rows].float()
        over.append(int(((a - b).abs() > KERNEL_RTOL * b.abs()
                         + KERNEL_ATOL_RMS * b.pow(2).mean().sqrt()).sum()))
    check(all(rel <= KERNEL_REL for _, _, rel in errs),
          f"{label}: backward kernels vs the chunked recompute {fmt_errs(errs)} (gated: rel "
          f"<= {KERNEL_REL} each)")
    del got, want
    dev_ms = device_ms(bwd, 5)
    kernel_us = kernel_device_us(bwd, 5)  # Delta, dK/dV, dQ apart (reported)
    plain_ms = cuda_ms(lambda: sf.sparse_packed_attention_bwd_plain(
        q, k, v, out, lse, g, ids, d**-0.5, out_lo=out_lo), 1, 0)
    pairs = int(train_packed_mask(*ids).sum())
    # five products over the visible pairs; q, out, its residual, dout, dq
    # [S, H, D] and k, v, dk, dv [S, KH, D] once each, lse and the ids
    flops = 10 * d * h * pairs
    bytes_ = 2 * s * d * (5 * h + 4 * kh) + 4 * h * s + 3 * 4 * s
    bms, by = bound_ms(flops, bytes_)
    # SDPA's backward (boolean mask, autograd) and the kernels' call, in
    # turns: SDPA, kernels, kernels, SDPA
    sdpa = [sdpa_backward(q, k, v, ids, g)]
    turns = [cuda_ms(bwd, 5), cuda_ms(bwd, 5)]
    sdpa.append(sdpa_backward(q, k, v, ids, g))
    call_ms = sum(turns) / 2
    full = [x["ms"] for x in sdpa if x["S"] == s]
    lib_ms = sum(full) / len(full) if len(full) == 2 else None
    row = dict(shape=f"{label} S={s}, H={h}, KH={kh}, D={d}, {pairs} visible pairs "
                     f"({pairs / s / s:.3f} of S^2)",
               max_abs_err=max(e[0] for e in errs), errors=errs, over_limit=over,
               outputs=[int(rows.sum()) * n * d for n in (h, kh, kh)],
               device_ms=dev_ms, kernel_device_us=kernel_us, call_ms=call_ms,
               turns_call_ms=[sdpa[0]["ms"], *turns, sdpa[1]["ms"]],
               plain_ms=plain_ms, plain="sparse_packed_attention_bwd_plain (chunk 512)",
               recompute_ms=recompute_ms, recompute_peak_gib=recompute_peak_gib,
               library_ms=lib_ms, sdpa_backward=sdpa, bound_ms=bms, bound_by=by,
               tflops=flops / dev_ms / 1e9, peak_gib=peak_gib, pairs=pairs, S=s)
    log(f"[train] B3's backward kernels at {row['shape']}: vs the chunked recompute "
        f"{fmt_errs(errs)}, outputs over the elementwise limit {over} of {row['outputs']} "
        f"(gated: rel <= {KERNEL_REL}); device {dev_ms:.3f} ms ({flops / dev_ms / 1e9:.1f} "
        f"TFLOP/s over the visible pairs; by kernel "
        f"{', '.join(f'{n} {t:.1f} µs' for n, t in kernel_us.items())}), call {call_ms:.3f} ms, "
        f"bound {bms:.3f} ms ({by}); peak +{peak_gib:.3f} GiB; plain twin {plain_ms:.1f} ms; the chunked recompute "
        f"{recompute_ms:.1f} ms, +{recompute_peak_gib:.2f} GiB; SDPA's backward (bool mask, "
        f"autograd) in turns "
        + ", ".join(f"{x['ms']:.2f} ms at S={x['S']}" if x["ms"] is not None else "did not fit"
                    for x in sdpa)
        + f" around the kernels' {turns[0]:.3f}, {turns[1]:.3f} ms")
    del out, lse, out_lo, g
    torch.cuda.empty_cache()
    return row


def phase_sparse_train_shape(batch, cfg):
    """10b: B3 at the LLM's training shape, on the packed predicate of a
    batch from the packer: the forward against the chunked plain version
    (the dense [S, S] plain version needs ~30 GB of logits there), its
    device time, the operations bound over the visible pairs and SDPA with
    the boolean mask; then the backward kernels there and at the SigLIP
    tower's packed length in the same batch (`backward_at_shape`)."""
    from bagel_tpu_torch.models.siglip import segment_ids_for_kernel
    from bagel_tpu_torch.ops import sparse_flash as sf
    from bagel_tpu_torch.ops.attention import train_packed_mask
    from bagel_tpu_torch.ops.chunked import chunked_packed_attention

    h, kh, d = cfg.llm.num_attention_heads, cfg.llm.num_key_value_heads, cfg.llm.head_dim
    ids = tuple(t[0].to(torch.int32).contiguous() for t in
                (batch.document_id, batch.fan_id, batch.noise_id))
    s = ids[0].shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    q, k, v = sparse_inputs(gen, s, h, kh, d)
    tables = sf.kernel_tables(*ids)
    got = sf.sparse_packed_attention(q, k, v, *ids, tables=tables)
    with torch.no_grad():
        want = chunked_packed_attention(q, k, v, *ids, chunk=sf.BWD_CHUNK)
    err, ratio, rel = sparse_error(got, want, ids[0])
    # gated here: the norm-relative error. The elementwise limit is reported:
    # over ~95M outputs (40x phase 3's shapes) its tail reads 0.8-1.02 x the
    # limit from run to run (NVIDIA H100 80GB HBM3, 700 W; §6 of PERF.md)
    rows = ids[0] != 0
    g_, w_ = got[rows].float(), want[rows].float()
    over = int(((g_ - w_).abs() > KERNEL_RTOL * w_.abs()
                + KERNEL_ATOL_RMS * w_.pow(2).mean().sqrt()).sum())
    check(rel <= KERNEL_REL, f"B3 at the training shape S={s}: rel {rel:.3e} (limit "
                             f"{KERNEL_REL}), max abs {err:.3e} ({ratio:.2f} x the elementwise "
                             f"limit)")
    del got, want, g_, w_

    def launch():
        return sf.sparse_packed_attention(q, k, v, *ids, tables=tables)

    call_ms = cuda_ms(lambda: sf.sparse_packed_attention_train(q, k, v, *ids), 5)
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: chunked_packed_attention(q, k, v, *ids, chunk=sf.BWD_CHUNK), 2)
    tables_ms = cuda_ms(lambda: sf.kernel_tables(*ids), 5)
    mask = train_packed_mask(*ids)
    sdpa = sdpa_call(q[None], k[None], v[None], mask[None, None])
    turns = [device_ms(fn, 5) for fn in (sdpa, launch, launch, sdpa)]
    ms, lib_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    pairs = int(mask.sum())
    del mask, sdpa
    flops, bytes_ = 4 * d * h * pairs, 2 * 2 * s * d * (h + kh) + 3 * 4 * s
    bms, by = bound_ms(flops, bytes_)
    row = dict(shape=f"LLM training S={s}, H={h}, KH={kh}, D={d}, {pairs} visible pairs "
                     f"({pairs / s / s:.3f} of S^2)",
               max_abs_err=err, limit_ratio=ratio, over_limit=over, outputs=int(rows.sum()) * h * d,
               rel_err=rel, device_ms=ms, call_ms=call_ms,
               plain_ms=plain_ms, plain="ops.chunked (chunk 512, no grad)", library_ms=lib_ms,
               turns_ms=turns, bound_ms=bms, bound_by=by, tflops=flops / ms / 1e9,
               tables_ms=tables_ms, pairs=pairs, S=s)
    log(f"[train] B3 at the training shape {row['shape']}: vs chunked rel {rel:.3e} (limit "
        f"{KERNEL_REL}), max abs {err:.3e}, {ratio:.2f} x the elementwise limit at worst, "
        f"{over} of {row['outputs']} outputs over it; device time in turns SDPA {turns[0]:.3f}, "
        f"kernel {turns[1]:.3f}, kernel {turns[2]:.3f}, SDPA {turns[3]:.3f} ms; kernel "
        f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s over the visible pairs), call "
        f"{call_ms:.3f} ms (tables included), tables {tables_ms:.3f} ms, plain (chunked) "
        f"{plain_ms:.3f} ms, bound {bms:.3f} ms ({by})")
    row["backward"] = backward_at_shape("LLM training", q, k, v, ids, tables, gen)
    del q, k, v, tables
    torch.cuda.empty_cache()
    # the SigLIP tower's packed length in this batch: its 16 heads of 72
    vh, vd = cfg.vit.num_attention_heads, cfg.vit.head_dim
    vit_ids = segment_ids_for_kernel(batch.vit_seg_ids.reshape(-1))
    q, k, v = sparse_inputs(gen, vit_ids[0].shape[0], vh, vh, vd)
    row["vit_backward"] = backward_at_shape("SigLIP training", q, k, v, vit_ids,
                                            sf.kernel_tables(*vit_ids), gen)
    del q, k, v
    torch.cuda.empty_cache()
    return row


def sdpa_backward(q, k, v, ids, g):
    """The backward of SDPA with the packed predicate as a boolean mask, under
    autograd: one PyTorch call's gradient of the same function (a yardstick
    for B3's backward; the port never calls it). At the full length, or, if
    that runs out of memory, at the first half of the packed sequence (the
    ids of a prefix are a packed predicate too): {ms, S, oom}; ms and S None
    if neither fits (reported, not gated)."""
    from bagel_tpu_torch.ops.attention import train_packed_mask

    oom = None
    for n in (q.shape[0], q.shape[0] // 2):
        try:
            mask = train_packed_mask(*(t[:n] for t in ids))
            qkv = [t[:n].detach().clone().requires_grad_() for t in (q, k, v)]
            out = sdpa_call(*(t[None] for t in qkv), mask[None, None])()
            grad = g[:n].transpose(0, 1)[None]  # [1, H, n, D], as SDPA's output
            ms = cuda_ms(lambda: torch.autograd.grad(out, qkv, grad, retain_graph=True), 2)
            return dict(ms=ms, S=n, oom=oom)
        except torch.cuda.OutOfMemoryError as e:
            oom = str(e).splitlines()[0][:200]
            mask = qkv = out = grad = None
            torch.cuda.empty_cache()
    return dict(ms=None, S=None, oom=oom)  # reported as not measured


def write_train_corpus(root, cfg):
    """Seeded images in two parquet corpora under `root`: 16 text-to-image
    rows (TRAIN_PX square, a caption) and 8 edit chains of four frames
    (three hops of instructions); a dataset config in which every packed
    sequence holds an edit chain (is_mandatory), so every step runs the
    SigLIP tower."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    import yaml
    from PIL import Image

    from bagel_tpu_torch.data.datasets import register_dataset_info

    rng = np.random.default_rng(SEED + 12)

    def png(px=TRAIN_PX):
        # smooth noise: cheap to encode, with structure at every scale
        small = rng.integers(0, 255, (px // 16, px // 16, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(small).resize((px, px), Image.BICUBIC).save(buf, "PNG")
        return buf.getvalue()

    for d in ("t2i", "edit"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    pq.write_table(pa.Table.from_pylist(
        [{"image": png(), "captions": json.dumps({"c": f"{PROMPT} ({i})"})} for i in range(16)]),
        os.path.join(root, "t2i", "p0.parquet"), row_group_size=8)
    pq.write_table(pa.Table.from_pylist(
        [{"image_list": [png() for _ in range(4)],
          "instruction_list": [[EDIT, "Make it darker"]] * 3} for _ in range(8)]),
        os.path.join(root, "edit", "p0.parquet"), row_group_size=4)
    register_dataset_info("t2i_pretrain", "smoke_t2i", data_dir=os.path.join(root, "t2i"))
    register_dataset_info("unified_edit", "smoke_edit", data_dir=os.path.join(root, "edit"))
    vae_px, vit_px = TRAIN_PX, TRAIN_PX // 14 * 14 - 14  # 490 at 512: 35 patches a side
    vae_tf = {"max_image_size": vae_px, "min_image_size": vae_px // 2,
              "image_stride": cfg.latent_downsample, "max_pixels": vae_px * vae_px}
    vit_tf = {"max_image_size": vit_px, "min_image_size": vit_px // 2,
              "image_stride": cfg.vit.patch_size, "max_pixels": vit_px * vit_px}
    path = os.path.join(root, "data.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({
            "t2i_pretrain": {"dataset_names": ["smoke_t2i"], "weight": 0.5,
                             "image_transform_args": vae_tf},
            "unified_edit": {"dataset_names": ["smoke_edit"], "weight": 0.5,
                             "is_mandatory": True, "image_transform_args": vae_tf,
                             "vit_image_transform_args": vit_tf},
        }, f)
    return path


def train_argv(data_yaml, ckpt_dir, *extra):
    return ["--device", DEVICE, "--preset", TRAIN_PRESET,
            "--num_hidden_layers", str(TRAIN_LAYERS), "--mock_tokenizer",
            "--dataset_config", data_yaml, "--ckpt_dir", ckpt_dir,
            "--expected_num_tokens", str(TRAIN_TOKENS[0]), "--max_num_tokens",
            str(TRAIN_TOKENS[1]), "--max_num_tokens_per_sample", str(TRAIN_TOKENS[0]),
            "--sparse_block", "128", "--remat", "full", "--warmup_steps", "1",
            "--lr", str(TRAIN_LR), "--log_every", "1", "--seed", str(SEED), *extra]


def group_grad_gaps(a, b):
    """{group: ||a - b|| / ||b||} over the top-level groups with a gradient."""
    from bagel_tpu_torch.train.step import tree_leaves

    out = {}
    for name in b:
        pairs = [(x, y) for x, y in zip(tree_leaves(a[name]), tree_leaves(b[name]))
                 if y is not None]
        if not pairs:
            continue
        num = sum(float((x.to(y.device).float() - y.float()).square().sum()) for x, y in pairs)
        den = sum(float(y.float().square().sum()) for _, y in pairs)
        out[name] = (num / max(den, 1e-30)) ** 0.5
    return out


def phase_train(card):
    """10: the B3 gradient (10a), B3 at the training shape (10b), then the
    trainer at full width (10c): the model gate and its control, a falling
    loss on a fixed batch, B3's launches per step, the driver's timed run,
    and a checkpoint with an --auto_resume that is bit-equal."""
    import shutil

    from bagel_tpu_torch.data.packing import stack_batches
    from bagel_tpu_torch.models.bagel import init_bagel_params
    from bagel_tpu_torch.ops import sparse_flash as sf
    from bagel_tpu_torch.train import driver
    from bagel_tpu_torch.train.checkpoint import get_latest_ckpt, step_from_path
    from bagel_tpu_torch.train.step import (
        grad_step,
        init_train_state,
        make_lr_schedule,
        make_optimizer,
        make_train_step,
        set_trainable,
        tree_leaves,
    )

    out = dict(grad=phase_sparse_grad())
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    argv = train_argv(os.path.join(root, "data.yaml"), os.path.join(root, "ckpt"))
    args = driver.parse_args(argv)
    cfg = driver.build_config(args)
    data_yaml = write_train_corpus(root, cfg)
    import importlib.util

    # the driver's data path reads parquet (pyarrow), its dataset config (yaml)
    # and the images (PIL): checked here, not caught as a failure later
    missing = [m for m in ("pyarrow", "yaml", "PIL") if importlib.util.find_spec(m) is None]
    check(not missing, f"the training data path needs {missing}")
    import PIL
    import pyarrow
    import yaml

    free = shutil.disk_usage(root).free / 2**30
    log(f"[train] data path: pyarrow {pyarrow.__version__}, yaml {yaml.__version__}, PIL "
        f"{PIL.__version__}; a parquet corpus of seeded images under {root} ({free:.0f} GiB "
        f"free); the depth cut: {TRAIN_LAYERS} of 28 LLM "
        f"layers (SigLIP {cfg.vit.num_hidden_layers}), full width; packed length "
        f"{TRAIN_TOKENS[0]} expected, {TRAIN_TOKENS[1]} at most (the reference: 32768 / 36864)")

    # one batch from the packer (the driver's loader: the VAE encode on the card)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    params = init_bagel_params(gen, cfg, torch.float32, device=DEVICE)
    with torch.no_grad():
        live_weights(params, cfg, gen)
    frozen = ("vae",)
    set_trainable(params, frozen)
    random.seed(SEED)  # the datasets draw captions and edit windows from it
    loader = driver.make_loader(args, cfg, params["vae"], {}, torch.device(DEVICE))
    batch, _ = next(iter(loader))
    loader.stop()
    bb = stack_batches([batch])
    noise = torch.randn(bb.vae_patches.shape, generator=gen, device=DEVICE)
    n_vit = int((bb.vit_seg_ids > 0).sum())
    log(f"[train] one packed batch: S={bb.seq_len}, {int((bb.document_id > 0).sum())} live "
        f"tokens in {int(bb.document_id.max())} samples, {n_vit} ViT tokens, "
        f"{int((bb.mse_weight > 0).sum())} noised VAE tokens, {int((bb.ce_weight > 0).sum())} "
        f"CE tokens")
    check(n_vit > 0, "the packed batch holds no ViT token: the SigLIP pass would not run")
    out["shape"] = phase_sparse_train_shape(bb, cfg)

    # model gate: --sparse_block against --attn_chunk 512, one batch, the same weights
    kw = dict(ce_weight=args.ce_weight, mse_weight=args.mse_weight, remat="full")
    counts = counts_reset()
    g_sparse, m_sparse = grad_step(params, cfg, bb, noise, sparse_block=128, **kw)
    launches, bwd_launches = counts()["b3"], counts()["b3_bwd"]
    # B3: each LLM layer's forward and its remat recompute, each SigLIP
    # layer's forward; its backward kernels once a layer of each
    per_step = 2 * TRAIN_LAYERS + cfg.vit.num_hidden_layers
    bwd_per_step = TRAIN_LAYERS + cfg.vit.num_hidden_layers
    check(launches == per_step and bwd_launches == bwd_per_step,
          f"B3 launched {launches} times and its backward {bwd_launches} times in one "
          f"training forward and backward, expected 2 x {TRAIN_LAYERS} + "
          f"{cfg.vit.num_hidden_layers} = {per_step} and {TRAIN_LAYERS} + "
          f"{cfg.vit.num_hidden_layers} = {bwd_per_step}")
    g_chunk, m_chunk = grad_step(params, cfg, bb, noise, attn_chunk=512, **kw)
    check(counts()["b3"] == launches + cfg.vit.num_hidden_layers
          and counts()["b3_bwd"] == bwd_launches + cfg.vit.num_hidden_layers,
          "the --attn_chunk path launched B3 or its backward in the LLM")
    loss_gap = abs(float(m_sparse["loss"]) - float(m_chunk["loss"])) / abs(float(m_chunk["loss"]))
    gaps = group_grad_gaps(g_sparse, g_chunk)
    del g_sparse
    check(loss_gap <= TRAIN_LOSS_TOL and max(gaps.values()) <= TRAIN_GRAD_TOL,
          f"model gate: loss gap {loss_gap:.3e} (limit {TRAIN_LOSS_TOL}), gradient gaps "
          f"{json.dumps(gaps)} (limit {TRAIN_GRAD_TOL})")
    # control: the packed samples merged into one document (attention across
    # samples, what a packing fault gives); the noise predicate alone may not
    # matter in a batch (it does only where a token follows a noise split in
    # its sample), and 10a's control holds it
    blind_bb = dataclasses.replace(bb, document_id=(bb.document_id != 0).to(bb.document_id.dtype))
    g_blind, m_blind = grad_step(params, cfg, blind_bb, noise, sparse_block=128, **kw)
    blind_loss = abs(float(m_blind["loss"]) - float(m_chunk["loss"])) / abs(float(m_chunk["loss"]))
    blind_gaps = group_grad_gaps(g_blind, g_chunk)
    del g_blind, g_chunk
    check(not (blind_loss <= TRAIN_LOSS_TOL and max(blind_gaps.values()) <= TRAIN_GRAD_TOL),
          f"model gate accepts the sparse path with the samples merged: loss gap "
          f"{blind_loss:.3e}, gradient gaps {json.dumps(blind_gaps)}")
    log(f"[train] model gate --sparse_block vs --attn_chunk 512: loss "
        f"{float(m_sparse['loss']):.5f} "
        f"vs {float(m_chunk['loss']):.5f} (gap {loss_gap:.2e}, limit {TRAIN_LOSS_TOL}); gradient "
        f"gaps {json.dumps({k: round(v, 5) for k, v in gaps.items()})} (limit {TRAIN_GRAD_TOL}); "
        f"B3 {launches} launches a step (2 x {TRAIN_LAYERS} LLM + {cfg.vit.num_hidden_layers} "
        f"SigLIP), its backward {bwd_launches} ({TRAIN_LAYERS} + "
        f"{cfg.vit.num_hidden_layers}); control with the samples merged into one document rejected: loss gap "
        f"{blind_loss:.2e}, "
        f"gradient gaps {json.dumps({k: round(v, 5) for k, v in blind_gaps.items()})}")
    out["gate"] = dict(loss_gap=loss_gap, grad_gaps=gaps, control_loss_gap=blind_loss,
                       control_grad_gaps=blind_gaps, b3_per_step=launches,
                       b3_bwd_per_step=bwd_launches)
    torch.cuda.empty_cache()

    # a falling loss on one fixed batch (the same noise every step)
    tx = make_optimizer(make_lr_schedule(TRAIN_LR, warmup_steps=1), frozen=frozen)
    state = init_train_state(params, tx, use_ema=True)
    step = make_train_step(cfg, tx, args.ce_weight, args.mse_weight, args.ema, frozen=frozen,
                           sparse_block=128)
    losses = []
    counts = counts_reset()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, bb, noise=noise)
        losses.append(float(m["loss"]))
        check(np.isfinite(losses[-1]) and float(m["grad_norm"]) > 0,
              f"fixed batch: loss {losses[-1]}, grad norm {float(m['grad_norm'])}")
    check(counts()["b3"] == TRAIN_STEPS * per_step
          and counts()["b3_bwd"] == TRAIN_STEPS * bwd_per_step,
          f"fixed batch: B3 {counts()['b3']} launches and its backward {counts()['b3_bwd']} in "
          f"{TRAIN_STEPS} steps, expected {TRAIN_STEPS} x {per_step} and {TRAIN_STEPS} x "
          f"{bwd_per_step}")
    check(losses[-1] < losses[0], f"fixed batch: the loss does not fall: {losses}")
    log(f"[train] fixed batch, {TRAIN_STEPS} steps (lr {TRAIN_LR}, warmup 1: the first "
        f"update has lr 0): losses {[round(x, 5) for x in losses]}")
    out["fixed_batch_losses"] = losses
    del state, params, step, tx, bb, blind_bb, batch, noise
    gc_cuda()

    # the driver, timed: every group but the VAE trained, EMA on; the first
    # step warms up
    counts = counts_reset()
    random.seed(SEED)
    t0 = time.perf_counter()
    state, history = driver.main(argv + ["--total_steps", str(TRAIN_STEPS), "--save_every",
                                         str(10 * TRAIN_STEPS)])
    wall = time.perf_counter() - t0
    b3, b3_bwd = counts()["b3"], counts()["b3_bwd"]
    check(b3 == TRAIN_STEPS * per_step and b3_bwd == TRAIN_STEPS * bwd_per_step,
          f"driver: B3 {b3} launches and its backward {b3_bwd} in {TRAIN_STEPS} steps, expected "
          f"{TRAIN_STEPS} x {per_step} and {TRAIN_STEPS} x {bwd_per_step}")
    check(all(np.isfinite(h["loss"]) for h in history), f"driver: losses {history}")
    timed = history[1:]
    secs = sum(h["seconds"] for h in timed)
    tokens = sum(h["tokens"] for h in timed)
    mfu = sum(h["model_tflop"] for h in timed) * 1e12 / secs / PEAK_FLOPS
    peak = max(h.get("peak_gib", 0.0) for h in history)
    timing = dict(s_per_step=secs / len(timed), tokens_per_s=tokens / secs, mfu=mfu,
                  peak_gib=peak, steps=history, wall_s=wall, b3_launches=b3,
                  b3_bwd_launches=b3_bwd)
    log(f"[train] driver --sparse_block 128 --remat full, {TRAIN_STEPS} steps ({card}): "
        f"{timing['s_per_step']:.3f} s/step, {timing['tokens_per_s']:.0f} tokens/s, MFU "
        f"{mfu * 100:.2f}% of {PEAK_FLOPS / 1e12:.0f} TFLOP/s (analytic model FLOPs, each token "
        f"through one expert), peak {peak:.2f} GiB; losses "
        f"{[round(h['loss'], 5) for h in history]}; {wall:.1f} s with the final save")
    out["timing"] = timing
    del state
    shutil.rmtree(os.path.join(root, "ckpt"), ignore_errors=True)
    gc_cuda()

    # checkpoint and resume through the driver: the LLM and SigLIP frozen and
    # no EMA, so that two saves fit this machine's disk (a full one is ~40 GB)
    ck_argv = train_argv(data_yaml, os.path.join(root, "ck"), "--freeze_llm", "--freeze_vit",
                         "--ema", "0", "--save_every", "2", "--total_steps", "3")
    random.seed(SEED)
    state, history = driver.main(ck_argv)
    ck_dir = os.path.join(root, "ck")
    saved = sorted(os.listdir(ck_dir))
    check(saved == ["0000002", "0000003"], f"checkpoints {saved}, expected a save at step 2 "
                                           f"and the final one at 3")
    want = [t.detach().cpu() for t in tree_leaves(state.params)]
    del state
    gc_cuda()
    resumed, again = driver.main(ck_argv + ["--auto_resume"])
    check(again == [] and resumed.step == 3 and resumed.opt_state["count"] == 3,
          f"--auto_resume: steps run {[h['step'] for h in again]}, step {resumed.step}")
    same = all(torch.equal(a, b.detach().cpu())
               for a, b in zip(want, tree_leaves(resumed.params)))
    check(same, "--auto_resume: the restored parameters differ from the saved run's")
    check(step_from_path(get_latest_ckpt(ck_dir)) == 3, "--auto_resume: wrong latest checkpoint")
    log(f"[train] checkpoints at steps 2 (async) and 3 (final); --auto_resume restored step 3 "
        f"with every parameter bit-equal ({len(want)} leaves) and ran no step past "
        f"--total_steps")
    out["resume"] = dict(saved=saved, bit_equal=same)
    del resumed, want
    shutil.rmtree(root, ignore_errors=True)
    gc_cuda()
    return out


# Phase 11: the trainer under torchrun's environment (child processes, nccl)
# and multi-process serving. Each trainer child starts from live weights
# (`live_place`: with llm2vae at zero the first loss would not depend on the
# model) and, at its first micro-step, holds the path's gradient against the
# plain path's on the same weights and batch (`child_gate`): each top-level
# group's ||g - g_plain|| / ||g_plain|| and the loss, relative; a control,
# the same path with no attention on the first quarter of each layer's query
# rows, must exceed the gradient limit. (a) runs at world 1 on one card: the
# mesh run at phase 10's packing against the plain B3 path, the pipeline
# against the plain chunked path on its two rows (the same attention, only
# the schedule differs: PAR_LOSS_TOL / PAR_GRAD_TOL), the ring against the
# chunked path (another attention under bf16 autocast, which rounds the
# ring's unnormalized probabilities where the chunked path rounds normalized
# ones: phase 10's TRAIN_LOSS_TOL / TRAIN_GRAD_TOL). The children save no
# checkpoint (the driver's save is replaced by a recorder): phase 10 and the
# CPU tests hold the save and --auto_resume bit for bit.
TRAIN11_TOKENS = (16384, 18432)  # --expected_num_tokens, --max_num_tokens of pp and cp
TRAIN11_STEPS = 2  # the pipeline and ring runs' steps (the first warms up)
PAR_LOSS_TOL = 1e-5  # the first loss against the plain path's (same attention), relative
PAR_GRAD_TOL = 1e-3  # each group's gradient against the plain path's (same attention)
CHILD_TIMEOUT = 600  # seconds a child may take
SERVE11_PROMPTS = serve_prompts() + [QUESTION, "Name three things that are often red."]
PAR_SERVE_CFG = "BagelConfig"  # the serving children's config (configs.<name>())
# the module constants a child process takes from its parent
CHILD_CONSTS = ("DEVICE", "SEED", "MAX_KV", "SERVE_SLOTS", "SERVE_CHUNK", "SERVE_TOKENS",
                "PAR_SERVE_CFG", "CHILD_TIMEOUT", "SHARD_TP", "SHARD_CFG", "SHARD_VQA_PX",
                "SHARD_DECODE", "FORWARD_PX", "VQA_PX", "MAX_THINK", "SERVE_VIT_TF",
                "SERVE_VAE_TF")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_children(label, specs, timeout=CHILD_TIMEOUT):
    """One `python3 chip_smoke.py --child SPEC` per spec with torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT on
    127.0.0.1), all started together; every one is joined or killed within
    `timeout`. Returns their JSON outputs; any exit code but 0 fails."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_children")
    os.makedirs(root, exist_ok=True)
    port, world = free_port(), len(specs)
    procs, logs = [], []
    for r, spec in enumerate(specs):
        spec = dict(spec, out=os.path.join(root, f"{label}.{r}.json"),
                    consts={k: globals()[k] for k in CHILD_CONSTS})
        path = os.path.join(root, f"{label}.{r}.spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(spec.get("local_rank", r)), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        log_f = open(os.path.join(root, f"{label}.{r}.log"), "w+")
        logs.append(log_f)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", path],
                                      cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                                      stdout=log_f, stderr=subprocess.STDOUT))
    end = time.monotonic() + timeout
    try:  # until all are done, one fails (the rest would wait on it) or time is up
        while time.monotonic() < end and any(p.poll() is None for p in procs) \
                and not any(p.poll() for p in procs):
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tails = []
    for r, f in enumerate(logs):
        f.seek(0)
        tails.append(f"--- {label} process {r} ---\n" + f.read()[-6000:])
        f.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        log("\n".join(tails))
    check(not any(codes), f"{label}: child exit codes {codes} (-9: killed, past {timeout} s "
                          f"or after another failed)")
    outs = []
    for r in range(world):
        with open(os.path.join(root, f"{label}.{r}.json")) as f:
            outs.append(json.load(f))
    return outs


def child_main(spec_path) -> int:
    """A child process of phases 11 and 12: one trainer run, one serving
    process or one sharded engine. A child still running a little before
    its timeout prints every thread's stack into its log and exits."""
    import faulthandler

    with open(spec_path) as f:
        spec = json.load(f)
    globals().update(spec["consts"])
    faulthandler.dump_traceback_later(max(CHILD_TIMEOUT - 20, 10), exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = dict(train=child_train, serve=child_serve, sharded=child_sharded,
               sharded_cards=child_sharded_cards)[spec["kind"]](spec)
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    return 0


def child_train(spec):
    """driver.main under torchrun's environment: the driver starts the
    process group (nccl on CUDA); live weights from its seed; the gate at
    the first micro-step where the spec asks for it; the saves recorded,
    not written; B3's launches counted over the run, the gate's excepted."""
    import torch.distributed as dist

    from bagel_tpu_torch.data.datasets import register_dataset_info
    from bagel_tpu_torch.train import driver

    for group, name, data_dir in spec["datasets"]:
        register_dataset_info(group, name, data_dir=data_dir)
    seen, saves = {}, []
    make, init = driver.make_layout, driver.init_bagel_params

    def spy(*a):  # the group as the driver started it
        seen.update(backend=dist.get_backend(), world=dist.get_world_size())
        layout = make(*a)
        seen["mesh"] = layout.mesh.shape if layout is not None else None
        return layout

    def live_init(gen, cfg, *a, place=None, **k):
        return init(gen, cfg, *a, place=live_place(gen, cfg, place), **k)

    driver.make_layout, driver.init_bagel_params = spy, live_init
    driver.save_checkpoint = lambda ckpt_dir, step, *a, **k: saves.append(step)
    random.seed(SEED)
    read = counts_reset()
    gate = child_gate(spec["gate"], driver, read) if spec.get("gate") else None
    _, history = driver.main(spec["argv"])
    counts = read()
    if gate is not None:
        counts = {k: n - gate["launches"].get(k, 0) for k, n in counts.items()}
    return dict(history=history, counts=counts, saves=saves, gate=gate, **seen)


def child_gate(plain, driver, read):
    """Wraps driver.grad_step: at the first micro-step, (a) the path's
    gradient against the plain path's (`plain`: its attn_chunk /
    sparse_block) on the same weights and batch, every tree unsharded (rank
    0 runs the plain path on the whole tree and compares), and (b) the
    control, the path again with no attention on the first quarter of each
    layer's query rows (padding lies at the end), against the path's own. Returns the dict it fills:
    loss gap, group gaps, control gaps, the gate's launches."""
    import torch.distributed as dist

    from bagel_tpu_torch.models import qwen2

    real, out = driver.grad_step, {}

    def whole(layout, tree, prefix=""):
        if isinstance(tree, dict):
            return {k: whole(layout, v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(whole(layout, v, f"{prefix}/{i}") for i, v in enumerate(tree))
        if tree is None or layout is None:
            return tree
        return layout.unshard(prefix, tree).requires_grad_(tree.requires_grad)

    def moved(tree, dev):  # a gradient tree's copy on `dev`
        if isinstance(tree, dict):
            return {k: moved(v, dev) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(moved(v, dev) for v in tree)
        return tree if tree is None else tree.detach().to(dev)

    def faulty(make_attend):
        def make(*a, **k):
            attend = make_attend(*a, **k)

            def f(q, k_, v):
                o = attend(q, k_, v)
                keep = torch.arange(o.shape[0], device=o.device) >= o.shape[0] // 4
                return o * keep.view(-1, *[1] * (o.ndim - 1)).to(o.dtype)
            return f
        return make

    def gated(params, cfg, bb, noise, layout, **kw):
        g, m = real(params, cfg, bb, noise, layout, **kw)
        if out:
            return g, m
        before = read()
        rank0 = not dist.is_initialized() or dist.get_rank() == 0
        # the card holds one gradient tree at a time, as in a step: the
        # driver's and the path's whole wait in host memory
        g_path, ref_params = moved(whole(layout, g), "cpu"), whole(layout, params)  # collective
        g_local = moved(g, "cpu")
        del g
        if rank0:
            plain_kw = dict(kw, context_parallel=None, pipeline_parallel=None,
                            expert_parallel=None, **plain)
            g_plain, m_plain = real(ref_params, cfg, bb, noise, None, **plain_kw)
            loss, ref = float(m["loss"]), float(m_plain["loss"])
            out.update(loss=loss, plain_loss=ref, loss_gap=abs(loss - ref) / abs(ref),
                       gaps=group_grad_gaps(g_path, g_plain))
            del g_plain
        del ref_params
        make_attend = qwen2._train_attend
        qwen2._train_attend = faulty(make_attend)
        try:
            g_ctl = whole(layout, real(params, cfg, bb, noise, layout, **kw)[0])
        finally:
            qwen2._train_attend = make_attend
        if rank0:
            out["control_gaps"] = group_grad_gaps(g_ctl, g_path)
        del g_ctl, g_path
        out["launches"] = {k: n - before[k] for k, n in read().items()}
        return moved(g_local, noise.device), m

    driver.grad_step = gated
    return out


def child_serve(spec):
    """One process of the lockstep server over a gloo bus: full-width bf16
    weights from SEED (live_weights), 8 slots; the leader sends the chats,
    then answers them once more on a ServingRuntime alone."""
    import pickle

    import torch.distributed as dist

    from bagel_tpu_torch import configs
    from bagel_tpu_torch.data.tokenizer import MockTokenizer
    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.models.bagel import init_bagel_params
    from bagel_tpu_torch.serving import multihost
    from bagel_tpu_torch.serving.runtime import ServingRuntime

    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    cuda = DEVICE == "cuda"
    if cuda:
        torch.cuda.set_device(0)  # every process on the one card
    cfg = getattr(configs, PAR_SERVE_CFG)()
    tok = MockTokenizer(cfg.llm.vocab_size)
    # one process builds its weights at a time: the seeded init's fp32
    # transients (~11 GB) of two processes at once do not fit beside the
    # other's 29 GB; the gen expert's perturbation is drawn a layer at a time
    for turn in range(dist.get_world_size()):
        if turn == rank:
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            params = init_bagel_params(gen, cfg, torch.bfloat16 if cuda else torch.float32,
                                       device=DEVICE)
            live_weights(params, cfg, gen, by_layer=True)
            if cuda:
                torch.cuda.empty_cache()
        dist.barrier()
    engine = BagelEngine(params, cfg, tok, tok.new_token_ids, max_kv=MAX_KV, device=DEVICE)

    class TimedBus(multihost.TorchDistBus):
        seconds: list = []

        def _bcast(self, payload):
            t0 = time.perf_counter()
            out = super()._bcast(payload)
            self.seconds.append(time.perf_counter() - t0)
            return out

    replayed = []
    unpack = multihost._unpack

    def recording(rec):  # the follower's requests, to read their answers
        req = unpack(rec)
        replayed.append(req)
        return req

    multihost._unpack = recording
    bus = TimedBus()
    fe = multihost.serve_multihost(engine, bus=bus, slots=SERVE_SLOTS, decode_chunk=SERVE_CHUNK,
                                   max_new_default=SERVE_TOKENS)
    rt = fe.runtime
    chunk_s, decode_step = [], rt._decode_step

    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def timed_step():
        sync()
        t0 = time.perf_counter()
        decode_step()
        sync()
        chunk_s.append(time.perf_counter() - t0)

    rt._decode_step = timed_step
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    read = counts_reset()
    fe.start()
    answers = alone = None
    wall = 0.0
    if fe.leader:  # two rounds of the chats: the first captures the decode graphs
        answers = []
        for timed in (False, True):
            if timed:
                del chunk_s[:], bus.seconds[:]
                tokens0 = rt.stats["tokens_out"]
            t0 = time.perf_counter()
            answers += [f.result(timeout=CHILD_TIMEOUT) for f in
                        [fe.submit_chat(p, max_new_tokens=SERVE_TOKENS) for p in SERVE11_PROMPTS]]
            wall = time.perf_counter() - t0
        round_tokens = rt.stats["tokens_out"] - tokens0
        fe.stop()
    else:
        fe.join(timeout=CHILD_TIMEOUT)
        round_tokens = 0
    counts = read()
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    if fe.error is not None:
        raise fe.error
    mine = [r.future.result(timeout=1) for r in replayed if hasattr(r, "prompt")]
    lockstep_s = list(bus.seconds)
    # the bus alone: an empty ingress batch broadcast back to back, both idle
    probe = pickle.dumps(([], False))
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(50):
        bus._bcast(probe if fe.leader else None)
    probe_ms = (time.perf_counter() - t0) / 50 * 1e3
    leader, ticks, stats = fe.leader, fe.ticks, dict(rt.stats)
    # the lockstep runtime's cache goes before the runtime alone takes its own
    del fe, rt, decode_step, timed_step
    if cuda:
        gc_cuda()
    if leader:  # the same chats on one runtime alone, twice
        single = ServingRuntime(engine, slots=SERVE_SLOTS, decode_chunk=SERVE_CHUNK,
                                max_new_default=SERVE_TOKENS)
        single.start()
        try:
            alone = [f.result(timeout=CHILD_TIMEOUT) for f in
                     [single.submit_chat(p, max_new_tokens=SERVE_TOKENS)
                      for p in SERVE11_PROMPTS * 2]]
        finally:
            single.stop()
    dist.barrier()
    dist.destroy_process_group()
    return dict(rank=rank, leader=leader, answers=answers if leader else mine,
                alone=alone, ticks=ticks, stats=stats, bus_s=lockstep_s,
                probe_ms=probe_ms, chunk_s=chunk_s, wall_s=wall, round_tokens=round_tokens,
                peak_gib=peak, counts=counts)


def par11_argv(data_yaml, ckpt_dir, *extra):
    """train_argv without --sparse_block, at TRAIN11_TOKENS a row."""
    argv = train_argv(data_yaml, ckpt_dir, *extra)
    i = argv.index("--sparse_block")
    del argv[i:i + 2]
    for flag, val in (("--expected_num_tokens", TRAIN11_TOKENS[0]),
                      ("--max_num_tokens", TRAIN11_TOKENS[1]),
                      ("--max_num_tokens_per_sample", TRAIN11_TOKENS[0])):
        argv[argv.index(flag) + 1] = str(val)
    return argv


def phase_parallel(card, train):
    """11: (a) the trainer in a child process under torchrun's environment
    (the process group nccl, world 1) from live weights: --mesh 1,1,1
    --sparse_block 128 (B3 and its backward launched and counted),
    --pipeline_parallel fsdp --attn_chunk 512 (two rows a step) and
    --context_parallel fsdp --attn_chunk 512 (the ring's block in 512-row
    query chunks), each with the gate of `child_gate` against the plain
    path and its control; (b) two serving processes on the one card over a
    gloo bus, 8 greedy chats: the leader's answers against a runtime alone,
    the follower's against the leader's, equal tick counts; (c) ep = 2,
    fsdp over every card, and fsdp at 28 layers with offload where the
    machine has two cards or more."""
    import shutil

    from bagel_tpu_torch.train import driver

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_par")
    shutil.rmtree(root, ignore_errors=True)
    ck = os.path.join(root, "ck")
    cfg = driver.build_config(driver.parse_args(train_argv("x", ck)))
    data_yaml = write_train_corpus(root, cfg)
    datasets = [("t2i_pretrain", "smoke_t2i", os.path.join(root, "t2i")),
                ("unified_edit", "smoke_edit", os.path.join(root, "edit"))]
    base = train_argv(data_yaml, ck, "--ema", "0", "--save_every", str(10 * TRAIN_STEPS))
    pp_extra = ("--attn_chunk", "512", "--pp_microbatches", "2")
    b3, chunked = dict(sparse_block=128, attn_chunk=None), dict(sparse_block=None, attn_chunk=512)
    runs = {  # name: (the child's argv, the plain path's attention, the loss and gradient limits)
        "mesh": (base + ["--mesh", "1,1,1", "--total_steps", str(TRAIN_STEPS)], b3,
                 PAR_LOSS_TOL, PAR_GRAD_TOL),
        "pp": (par11_argv(data_yaml, ck, "--ema", "0", "--total_steps", str(TRAIN11_STEPS),
                          "--mesh", "1,1,1", "--pipeline_parallel", "fsdp", *pp_extra),
               chunked, PAR_LOSS_TOL, PAR_GRAD_TOL),
        "cp": (par11_argv(data_yaml, ck, "--ema", "0", "--total_steps", str(TRAIN11_STEPS),
                          "--mesh", "1,1,1", "--context_parallel", "fsdp", "--attn_chunk", "512"),
               chunked, TRAIN_LOSS_TOL, TRAIN_GRAD_TOL),
    }
    per_step = 2 * TRAIN_LAYERS + cfg.vit.num_hidden_layers
    bwd_per_step = TRAIN_LAYERS + cfg.vit.num_hidden_layers
    out = dict(train={}, launches={})
    for name, (argv, plain, loss_tol, grad_tol) in runs.items():
        gc_cuda()
        check(torch.cuda.memory_allocated() < 2**30,
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated before the "
              f"{name} run")
        log(f"[parallel] before the {name} run this process holds "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        t0 = time.perf_counter()
        res = run_children(f"train_{name}", [dict(kind="train", argv=argv, datasets=datasets,
                                                  gate=plain)])[0]
        row = train_row(name, res, time.perf_counter() - t0, loss_tol, grad_tol)
        out["train"][name] = row
        out["launches"][f"train_{name}"] = res["counts"]
        check(res["backend"] == "nccl" and res["world"] == 1,
              f"train {name}: the driver's process group is {res['backend']} at world "
              f"{res['world']}, expected nccl at 1")
        if name == "mesh":
            check(row["b3"] == TRAIN_STEPS * per_step and row["b3_bwd"] == TRAIN_STEPS * bwd_per_step,
                  f"train mesh: B3 {row['b3']} launches and its backward {row['b3_bwd']} in "
                  f"{TRAIN_STEPS} steps, expected {TRAIN_STEPS} x {per_step} and "
                  f"{TRAIN_STEPS} x {bwd_per_step}")
        else:  # the LLM takes the plain attention: B3 runs in the SigLIP tower alone
            check(row["b3"] > 0 and row["b3"] == row["b3_bwd"]
                  and row["b3"] % cfg.vit.num_hidden_layers == 0,
                  f"train {name}: B3 {row['b3']} launches, its backward {row['b3_bwd']}: "
                  f"expected {cfg.vit.num_hidden_layers} of each per row with images")
        log(f"[parallel] train {name} ({card}; {res['backend']}, world {res['world']}, mesh "
            f"{res['mesh']}): {gate_text(row)}; {row['s_per_step']:.3f} s/step, "
            f"{row['tokens_per_s']:.0f} tokens/s, peak {row['peak_gib']:.2f} GiB; B3 "
            f"{row['b3']}, its backward {row['b3_bwd']} (the gate's excepted); losses "
            f"{[round(x, 5) for x in row['losses']]}; {row['wall_s']:.1f} s in the child")
    t10 = train["timing"]
    log(f"[parallel] phase 10's plain driver at its packing: {t10['s_per_step']:.3f} s/step, "
        f"{t10['tokens_per_s']:.0f} tokens/s, peak {t10['peak_gib']:.2f} GiB (with EMA)")
    shutil.rmtree(root, ignore_errors=True)
    gc_cuda()
    par_serve(card, out)
    par_multicard(cfg, out)
    return out


def train_row(name, res, wall, loss_tol=None, grad_tol=None):
    """A trainer child's numbers (the first step warms up; the peak is the
    timed steps'), its losses finite and its final save reached; with
    limits, its gate held (loss gap, every group's gradient gap) and its
    control rejected (a group's gap past the gradient limit)."""
    hist = res["history"]
    timed = hist[1:]
    secs = sum(h["seconds"] for h in timed)
    row = dict(mesh=res["mesh"], world=res["world"], s_per_step=secs / len(timed),
               tokens_per_s=sum(h["tokens"] for h in timed) / secs,
               peak_gib=max(h.get("peak_gib", 0.0) for h in timed),
               losses=[h["loss"] for h in hist], wall_s=wall, b3=res["counts"]["b3"],
               b3_bwd=res["counts"]["b3_bwd"], saves=res["saves"])
    check(all(np.isfinite(h["loss"]) for h in hist), f"train {name}: losses {row['losses']}")
    check(res["saves"] == [hist[-1]["step"] + 1],
          f"train {name}: saves at {res['saves']}, expected the final one alone")
    if loss_tol is None:
        return row
    gate = res["gate"]
    row.update(gate=gate, loss_tol=loss_tol, grad_tol=grad_tol)
    check(gate.get("gaps") and gate.get("control_gaps"), f"train {name}: no gate ran: {gate}")
    check(gate["loss"] == hist[0]["loss"],
          f"train {name}: the gate's loss {gate['loss']!r} is not step 0's {hist[0]['loss']!r}")
    check(gate["loss_gap"] <= loss_tol and max(gate["gaps"].values()) <= grad_tol,
          f"train {name}: {gate_text(row)}")
    check(max(gate["control_gaps"].values()) > grad_tol,
          f"train {name}: the control passed the gate: {gate_text(row)}")
    return row


def gate_text(row):
    g = row["gate"]
    return (f"first loss {g['loss']:.6f} vs the plain path's {g['plain_loss']:.6f} (rel gap "
            f"{g['loss_gap']:.2e}, limit {row['loss_tol']}), gradient gaps "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in g['gaps'].items()})} (limit "
            f"{row['grad_tol']}); control (no attention on the first quarter of the rows) "
            f"rejected: {json.dumps({k: float(f'{v:.3g}') for k, v in g['control_gaps'].items()})}")


def par_serve(card, out):
    """11b: two serving processes on this card over a gloo bus."""
    check(torch.cuda.memory_allocated() < 2**30,
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated before serving")
    log(f"[parallel] before serving this process holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    t0 = time.perf_counter()
    procs = run_children("serve", [dict(kind="serve", local_rank=0)] * 2)
    wall = time.perf_counter() - t0
    lead = next(p for p in procs if p["leader"])
    follow = next(p for p in procs if not p["leader"])
    check(lead["answers"] == lead["alone"],
          f"serve 2 processes: the leader's answers differ from a runtime alone: "
          f"{first_difference(json.dumps(lead['answers']), json.dumps(lead['alone']))}")
    check(follow["answers"] == lead["answers"],
          "serve 2 processes: the follower's answers differ from the leader's")
    check(follow["ticks"] == lead["ticks"] and follow["stats"] == lead["stats"],
          f"serve 2 processes: ticks {lead['ticks']} / {follow['ticks']}, stats {lead['stats']} / "
          f"{follow['stats']}")
    check(lead["stats"]["chat_done"] == 2 * len(SERVE11_PROMPTS) and lead["counts"]["b1"] > 0,
          f"serve 2 processes: {lead['stats']}, B1 {lead['counts']['b1']}")
    tokens = lead["round_tokens"]  # the timed second round's
    bus_ms = 1e3 * sum(lead["bus_s"]) / max(len(lead["bus_s"]), 1)
    chunk_tok = tokens / max(sum(lead["chunk_s"]), 1e-9)
    serve = dict(ticks=lead["ticks"], bus_ms_per_tick=bus_ms,
                 bus_probe_ms=[p["probe_ms"] for p in procs], tokens=tokens,
                 tokens_per_s_in_chunks=chunk_tok, tokens_per_s_wall=tokens / lead["wall_s"],
                 chunks=len(lead["chunk_s"]), chunk_ms=[1e3 * x for x in lead["chunk_s"]],
                 peak_gib=[p["peak_gib"] for p in procs], leader_wall_s=lead["wall_s"],
                 phase_wall_s=wall, answers_equal_alone=True, follower_equal=True)
    out["serve"] = serve
    out["launches"]["serve_multiprocess"] = lead["counts"]
    log(f"[parallel] serve: 2 processes on one card ({card}), a gloo bus, "
        f"{len(SERVE11_PROMPTS)} greedy chats of {SERVE_TOKENS} tokens at most, {SERVE_SLOTS} "
        f"slots: the leader's answers equal a runtime alone's, the follower's the leader's, "
        f"{lead['ticks']} ticks on both (two rounds); the second round: the broadcast "
        f"{bus_ms:.3f} ms a tick on the leader (lockstep: the follower's tick on the shared "
        f"card included), an idle broadcast {serve['bus_probe_ms'][0]:.3f} ms; {chunk_tok:.0f} "
        f"tokens/s in decode chunks of {[round(x, 1) for x in serve['chunk_ms']]} ms "
        f"({serve['tokens_per_s_wall']:.0f} over the round's {lead['wall_s']:.2f} s); "
        f"peak {serve['peak_gib'][0]:.2f} / {serve['peak_gib'][1]:.2f} "
        f"GiB a process; B1 {lead['counts']['b1']} launches in the leader; {wall:.1f} s with "
        f"both processes' set-up")


def par_multicard(cfg, out):
    """11c, where the machine has two cards or more: ep = 2 (--expert_parallel
    tp on a 1,n/2,2 mesh) and fsdp over every card at TRAIN_LAYERS, each
    with the gate of `child_gate` against one process's plain path on the
    whole tree; then fsdp at 28 layers with offload (finite losses, peak)."""
    import shutil

    n = torch.cuda.device_count()
    if n < 2:
        log(f"[parallel] (c) needs two cards or more ({n} on the machine): ep = 2, fsdp over "
            f"every card, and fsdp at 28 layers with offload not run")
        return
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_par")
    ck = os.path.join(root, "ck")
    data_yaml = write_train_corpus(root, cfg)
    datasets = [("t2i_pretrain", "smoke_t2i", os.path.join(root, "t2i")),
                ("unified_edit", "smoke_edit", os.path.join(root, "edit"))]
    steps = ("--ema", "0", "--total_steps", str(TRAIN11_STEPS))
    multi = {  # name: (argv, processes, the plain path's attention or None: no gate)
        "ep2": (par11_argv(data_yaml, ck, *steps, "--mesh", f"1,{n // 2},2",
                           "--expert_parallel", "tp", "--attn_chunk", "512"),
                n // 2 * 2, dict(sparse_block=None, attn_chunk=512)),
        "fsdp": (train_argv(data_yaml, ck, *steps, "--mesh", f"1,{n},1"), n,
                 dict(sparse_block=128, attn_chunk=None)),
        "fsdp28": (train_argv(data_yaml, ck, *steps, "--mesh", f"1,{n},1",
                              "--num_hidden_layers", "28", "--optimizer_offload"), n, None),
    }
    for name, (argv, procs, plain) in multi.items():
        t0 = time.perf_counter()
        res = run_children(f"train_{name}", [dict(kind="train", argv=argv, datasets=datasets,
                                                  gate=plain) for _ in range(procs)])
        tols = (PAR_LOSS_TOL, PAR_GRAD_TOL) if plain is not None else ()
        row = train_row(name, res[0], time.perf_counter() - t0, *tols)
        row["peak_gib"] = max(h.get("peak_gib", 0.0) for r in res for h in r["history"][1:])
        out["train"][name] = row
        log(f"[parallel] (c) train {name} on {procs} cards, mesh {row['mesh']}: "
            f"{gate_text(row) if plain is not None else 'no gate'}; {row['s_per_step']:.3f} "
            f"s/step, {row['tokens_per_s']:.0f} tokens/s, peak {row['peak_gib']:.2f} GiB a "
            f"card; losses {[round(x, 5) for x in row['losses']]}")
    shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 12: sharded inference
# ---------------------------------------------------------------------------


SHARD_TP = 2  # 12b: tensor parallelism over two processes on the one card
SHARD_CFG = "BagelConfig"  # phase 12's config (configs.<name>())
SHARD_VQA_PX = SERVE_GATE_PX  # 12b's VQA image: its blocks' all-reduces go through host memory
SHARD_DECODE = 4  # 12b's int4 decode steps (one whole chunk)
# 12b's greedy answers may part only at a near tie of one process's logits:
# its top two tokens within this fraction of the logits' standard deviation
NEAR_TIE = 5e-2


def collectives_reset():
    """The inference layout's collective counts set to 0. Returns read():
    {"all_reduce": {"eager": n, "captured": n}, "all_gather": {...}}, the
    calls issued since, those under CUDA-graph capture apart (each replay
    of their graph runs them again)."""
    from bagel_tpu_torch.parallel import mesh

    mesh.collectives.clear()

    def read():
        return {kind: {how: mesh.collectives[(kind, how)] for how in ("eager", "captured")}
                for kind in ("all_reduce", "all_gather")}

    return read


def nccl_replayed() -> int:
    """The kernel launches of the decode programs' replays whose names are
    NCCL's (none where NCCL copies a one-rank collective without a kernel)."""
    from bagel_tpu_torch.inference import decode_program

    return sum(n for name, n in decode_program.replayed_kernels.items() if "nccl" in name.lower())


def queued_answers(engine, chats, speculative):
    """The chats through a ServingRuntime over the engine's mesh, all queued
    before its first tick (one admission group, so two engines are held
    against each other on the same schedule): the answers, the runtime's
    stats, the launch and collective counts of the run, the decode chunks'
    host ms and the decode program's captures and forwards a graph."""
    from bagel_tpu_torch.serving.runtime import ServingRuntime
    from bagel_tpu_torch.serving.server import decode_png

    _, vit_tf = serve_transforms(engine.cfg)
    rt = ServingRuntime(engine, slots=SERVE_SLOTS, decode_chunk=SERVE_CHUNK,
                        max_new_default=SERVE_TOKENS, speculative=speculative, mesh=engine.mesh)
    chunk_s, step = [], rt._decode_step
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)

    def timed_step():
        sync()
        t0 = time.perf_counter()
        step()
        sync()
        chunk_s.append(time.perf_counter() - t0)

    rt._decode_step = timed_step
    futs = [rt.submit_chat(b["prompt"], image=decode_png(b["image"], vit_tf)
                           if b.get("image") else None) for b in chats]
    read, coll = counts_reset(), collectives_reset()
    rt.start()
    try:
        answers = [f.result(timeout=900) for f in futs]
    finally:
        rt.stop()
    counts, collectives = read(), coll()
    per_graph = min(rt.decode.spec_chunk if speculative else rt.decode.chunk, SERVE_CHUNK)
    return dict(answers=answers, stats=dict(rt.stats), counts=counts, collectives=collectives,
                captures=rt.decode.captures, per_graph=per_graph, chunks=len(chunk_s),
                chunk_ms_min=1e3 * min(chunk_s), chunk_ms_median=1e3 * float(np.median(chunk_s)))


def sharded_world1(card, t2i=None, vqa=None):
    """12a: the sharded code paths at world 1 through nccl (a mesh 1,1,1:
    nothing splits, and every tp and dp collective launches on the world
    group of this one process, in the decode programs' graphs too), on
    phase 5's weights (the same seed): phase 5's 1024 px image and its
    latent bit for bit (`t2i`, or the plain engine's when phase 12 runs
    alone), phase 6's VQA answer (`vqa`), and the 8-slot runtime over a
    bf16 and an int8 slot cache and with speculative=4, each answer equal
    to the plain engine's runtime on the same queue; launch counts and the
    collectives issued (eager and captured) against their formulas; the
    8-slot chunk's time beside the plain engine's."""
    import torch.distributed as dist

    from bagel_tpu_torch import configs
    from bagel_tpu_torch.data.tokenizer import MockTokenizer
    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.models.bagel import init_bagel_params
    from bagel_tpu_torch.parallel.mesh import InferenceLayout, leaf_paths, make_mesh

    group = dict(init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
    if DEVICE == "cuda":
        dist.init_process_group("nccl", device_id=torch.device(DEVICE, torch.cuda.current_device()),
                                **group)
    else:  # a rehearsal on the CPU
        dist.init_process_group("gloo", **group)
    try:
        cfg = getattr(configs, SHARD_CFG)()
        tok = MockTokenizer(cfg.llm.vocab_size)
        L, LV = cfg.llm.num_hidden_layers, cfg.vit.num_hidden_layers
        per_forward = 2 * L + 1  # o and down a layer, the embedding's sum
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        params = init_bagel_params(gen, cfg, torch.bfloat16 if DEVICE == "cuda" else torch.float32,
                                   device=DEVICE)
        live_weights(params, cfg, gen)
        gc_cuda()
        layout = InferenceLayout(make_mesh((1, 1, 1)), cfg)
        sparams = layout.place_tree(params)
        check(all(a is b for (_, a), (_, b) in zip(leaf_paths(params), leaf_paths(sparams))),
              "12a: a mesh 1,1,1 placed a leaf elsewhere than the whole leaf")

        def engines(**kw):
            return (BagelEngine(params, cfg, tok, tok.new_token_ids, max_kv=MAX_KV, device=DEVICE,
                                **kw),
                    BagelEngine(sparams, cfg, tok, tok.new_token_ids, max_kv=MAX_KV,
                                device=DEVICE, layout=layout, **kw))

        plain, sharded = engines()
        out = dict(launches={})
        with flash_int8(False):
            # phase 5: the image through __call__, then the latent
            coll = collectives_reset()
            img, secs, counts, peak = counted_call(lambda: sharded(
                text=PROMPT, image_shapes=(PX, PX),
                rng=torch.Generator(device=DEVICE).manual_seed(SEED), **CFG)["image"])
            c = coll()
            want = bf16_counts(b1=L * (2 + NUM_TIMESTEPS - 1))
            # 2 prompt prefills and 7 denoise forwards; the embedding sums of
            # the two prompts and of the boundary tokens of each CFG phase
            want_c = dict(all_reduce=dict(eager=2 * L * (2 + NUM_TIMESTEPS - 1) + 4, captured=0),
                          all_gather=dict(eager=0, captured=0))
            check(counts == want, f"12a t2i: launches {counts} != {want}")
            check(c == want_c, f"12a t2i: collectives {c} != {want_c}")
            noise = t2i["noise"] if t2i else torch.randn(
                (n_latents(cfg, PX), cfg.patch_latent_dim),
                generator=torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE
            ).cpu().numpy()

            def latent(eng):
                ctx, cfg_text, cfg_img = prompt_contexts(eng)
                return eng.gen_image((PX, PX), ctx, cfg_text_precontext=cfg_text,
                                     cfg_img_precontext=cfg_img, init_noise=noise,
                                     return_latent=True, **CFG)

            ref = t2i["latent"] if t2i else latent(plain)
            lat = latent(sharded)
            check(np.array_equal(lat, ref), f"12a: the sharded latent differs from phase 5's "
                  f"(max |diff| {float(np.abs(lat - ref).max()):.3e})")
            ref_img = t2i["image"] if t2i else plain(
                text=PROMPT, image_shapes=(PX, PX),
                rng=torch.Generator(device=DEVICE).manual_seed(SEED), **CFG)["image"]
            check(np.array_equal(img, ref_img), "12a: the sharded image differs from phase 5's")
            out["t2i"] = dict(s=secs, peak_gib=peak, launches=counts, collectives=c)
            out["launches"]["sharded_t2i"] = counts
            log(f"[sharded] 12a mesh 1,1,1 through nccl ({card}): text-to-image {PX} px, "
                f"{NUM_TIMESTEPS} timesteps, {secs:.2f} s: image and latent equal to phase 5's bit "
                f"for bit; launches {counts}; collectives {c} (expected {want_c})")

            # phase 6: the VQA, its decode through the program's graphs
            coll = collectives_reset()
            caps0 = sharded.decode.captures
            res, secs, counts, peak = counted_call(lambda: sharded(
                image=vqa_image(), text=QUESTION, understanding_output=True,
                max_think_token_n=MAX_THINK))
            c, nccl = coll(), nccl_replayed()
            answer = res["text"]
            ref = vqa["answer"] if vqa else plain(image=vqa_image(), text=QUESTION,
                                                  understanding_output=True,
                                                  max_think_token_n=MAX_THINK)["text"]
            check(answer == ref, f"12a VQA: the sharded answer differs from phase 6's at token "
                                 f"{first_difference(answer, ref)}")
            caps = sharded.decode.captures - caps0
            n_tok = len(answer.split())
            steps = n_tok + 1 if n_tok < MAX_THINK else MAX_THINK
            run = program_steps(steps, sharded.decode.chunk)
            graph_steps = min(sharded.decode.chunk, MAX_THINK)
            want = bf16_counts(b1=L * (2 + caps + run), b3=LV)
            # 2 prefills and the warm-up steps eager; each capture records a
            # chunk of steps, each with its all-reduces and the logits' gather
            want_c = dict(all_reduce=dict(eager=per_forward * (2 + caps),
                                          captured=per_forward * caps * graph_steps),
                          all_gather=dict(eager=caps, captured=caps * graph_steps))
            check(counts == want, f"12a VQA: launches {counts} != {want}")
            check(c == want_c, f"12a VQA: collectives {c} != {want_c}")
            out["vqa"] = dict(s=secs, answer_tokens=n_tok, launches=counts, collectives=c,
                              captures=caps, nccl_kernels_replayed=nccl)
            out["launches"]["sharded_vqa"] = counts
            log(f"[sharded] 12a VQA {VQA_PX} px, {MAX_THINK} tokens at most: {secs:.2f} s, the "
                f"answer equal to phase 6's ({n_tok} tokens); launches {counts}; collectives {c} "
                f"(expected {want_c}: {caps} capture(s) of {graph_steps} steps, {per_forward} "
                f"all-reduces and one logits gather a step); NCCL kernels in the replays: {nccl}")

            # phase 9: the 8-slot runtime over a bf16 cache, an int8 cache, speculative
            chats = serve_chats()
            out["serve"] = {}
            for label, kw, spec in (("bf16", {}, 0), ("int8", dict(kv_quant=True), 0),
                                    (f"speculative={SERVE_SPECULATIVE}", {}, SERVE_SPECULATIVE)):
                p_eng, s_eng = (plain, sharded) if not kw else engines(**kw)
                a = queued_answers(p_eng, chats, spec)
                b = queued_answers(s_eng, chats, spec)
                diffs = [first_difference(x, y) for x, y in zip(b["answers"], a["answers"])]
                check(all(d is None for d in diffs), f"12a serve ({label}): the sharded runtime's "
                      f"answers differ from the plain runtime's at tokens {diffs}")
                st = b["stats"]
                fwd = st["decode_forwards"] + b["captures"]
                if kw:
                    want = bf16_counts(b1=L * st["prefill_blocks"], b3=LV * st["vit_passes"],
                                       kv8=L * fwd)
                else:
                    want = bf16_counts(b1=L * (st["prefill_blocks"] + fwd),
                                       b3=LV * st["vit_passes"])
                check(b["counts"] == want, f"12a serve ({label}): launches {b['counts']} != {want}")
                captured = b["captures"] * b["per_graph"]
                c = b["collectives"]
                check(c["all_reduce"]["captured"] == per_forward * captured
                      and c["all_gather"]["captured"] == captured,
                      f"12a serve ({label}): captured collectives {c} != {per_forward} x "
                      f"{captured} all-reduces and {captured} gathers")
                out["serve"][label] = dict(
                    plain_chunk_ms=a["chunk_ms_min"], sharded_chunk_ms=b["chunk_ms_min"],
                    ratio=b["chunk_ms_min"] / a["chunk_ms_min"], stats=st, launches=b["counts"],
                    collectives=c, captures=b["captures"])
                out["launches"][f"sharded_serve_{label.split('=')[0]}"] = b["counts"]
                log(f"[sharded] 12a serve ({label}), 8 slots: answers equal to the plain "
                    f"runtime's on the same queue; a {SERVE_CHUNK}-step chunk {b['chunk_ms_min']:.1f}"
                    f" ms sharded vs {a['chunk_ms_min']:.1f} ms plain at best "
                    f"({b['chunk_ms_min'] / a['chunk_ms_min']:.3f}x); launches {b['counts']} "
                    f"(expected {want}); collectives {c}")
                del p_eng, s_eng
                gc_cuda()
        del plain, sharded, params, sparams
        gc_cuda()
        return out
    finally:
        dist.destroy_process_group()


class DropPartial:
    """An InferenceTP whose rank `rank` zeroes its partial sum of every o
    product before the all-reduce (12b's control)."""

    def __init__(self, tp, rank):
        self.tp, self.rank, self.calls = tp, rank, 0

    def __getattr__(self, name):
        return getattr(self.tp, name)

    def leave(self, x):
        import torch.distributed as dist

        self.calls += 1  # a layer's o, then its down
        if self.calls % 2 == 1 and dist.get_rank() == self.rank:
            x.zero_()
        return self.tp.leave(x)


class OwnScale:
    """An InferenceTP whose w8a8 row-parallel leaves quantize each rank's
    slice of a row with its own scale (no MAX over tp): 12b's w8a8
    control, what the port did before each row took its whole row's."""

    def __init__(self, tp):
        self.tp = tp

    def __getattr__(self, name):
        return getattr(self.tp, name)

    def row_max(self, amax):
        return amax


def whole_leaf_w8a8(q, params, layout):
    """The row-parallel leaves (o and down: their input rows split over tp)
    of a w8a8 tree quantized on this rank's shards, quantized again on the
    whole leaf and cut, as a w8a8 checkpoint arrives (the app quantizes,
    then places): a shard's own per-column scale, the max over its half of
    the input rows, would be another model than one process's. Each leaf
    is gathered over tp (collective), one at a time."""
    from bagel_tpu_torch.parallel.mesh import gather_plain
    from bagel_tpu_torch.utils.quant import quantize_weight

    layers = params["llm"]["layers"]
    for group in ("attn", "attn_gen", "mlp", "mlp_gen"):
        name = "o" if group.startswith("attn") else "down"
        if group not in layers:
            continue
        leaf = layers[group][name]
        whole = gather_plain(leaf["w"] if isinstance(leaf, dict) else leaf, -2, layout.tp.group)
        w = quantize_weight(whole)
        del whole
        path = f"llm/layers/{group}/{name}"
        q["llm"]["layers"][group][name] = dict(
            w_q8=layout.place(path + "/w_q8", w["w_q"]), scale=layout.place(path + "/scale",
                                                                           w["scale"]))
        del w


def shard_inputs(cfg):
    """12b's inputs: the gen block's x1 at FORWARD_PX and the VQA image."""
    x1 = torch.randn((n_latents(cfg, FORWARD_PX), cfg.patch_latent_dim),
                     generator=torch.Generator(device=DEVICE).manual_seed(SEED + 21), device=DEVICE)
    o = (VQA_PX - SHARD_VQA_PX) // 2
    return x1, vqa_image()[o:o + SHARD_VQA_PX, o:o + SHARD_VQA_PX]


def shard_paths(engine, x1, image):
    """The velocity of a full-depth gen block over the prompt's contexts,
    the first decode step's logits of the VQA context and its greedy
    answer (eager: gloo runs no collective inside a CUDA graph), and the
    VQA context."""
    L = engine.cfg.llm.num_hidden_layers
    vel = gen_block_velocity(engine, prompt_contexts(engine), x1, L, "auto")
    ctx = vqa_context(engine, image)
    logits = first_logits(engine, ctx, "auto")
    return vel, logits, engine.gen_text(ctx, max_length=MAX_THINK, graph=False), ctx


def answer_margins(engine, ctx, answer: str):
    """The logits along a greedy answer, teacher-forced (one causal block of
    bos and the answer's tokens over the context): at each step the top two
    tokens and their gap in units of the logits' standard deviation."""
    from bagel_tpu_torch.models import qwen2

    llm, layout = engine.params["llm"], engine.layout
    ids = [engine.new_token_ids["bos_token_id"]] + [int(t) for t in answer.split()]
    t = len(ids)
    hidden, _ = qwen2.llm_extend(
        llm, engine.cfg.llm, qwen2.embed_tokens(llm, engine._tensor([ids], torch.long), layout),
        engine._tensor([[ctx.rope + i for i in range(t)]]), ctx.cache, engine._tensor([t]),
        und_len=t, causal=True, update_cache=False, layout=layout)
    logits = qwen2.lm_logits(llm, hidden[0], layout)
    top = logits.topk(2, dim=-1)
    gap = (top.values[:, 0] - top.values[:, 1]) / logits.std(dim=-1)
    return [(a, b, g) for (a, b), g in zip(top.indices.tolist(), gap.tolist())]


def tp4_kernel_rows(cfg, gen):
    """B4 (M = 1, against its plain version) and B5 (M = 64, bit for bit)
    at the local shapes of tp = 4 (7 query heads and 1 KV head a rank):
    qkv and gate_up at N / 4, o and down at K / 4 (7 and 37 groups of 128),
    on random weights quantized on the card."""
    from bagel_tpu_torch.ops import int4_matmul as m4
    from bagel_tpu_torch.ops import int8_matmul as m8
    from bagel_tpu_torch.utils.quant import quantize_weight, quantize_weight_int4, to_kmajor

    llm, n = cfg.llm, 4
    hd, d, f = llm.head_dim, llm.hidden_size, llm.intermediate_size
    shapes = dict(qkv=(d, (llm.num_attention_heads + 2 * llm.num_key_value_heads) // n * hd),
                  o=(llm.num_attention_heads // n * hd, d), gate_up=(d, 2 * f // n),
                  down=(f // n, d))
    rows = []
    for name, (k, nn) in shapes.items():
        w = (torch.randn((k, nn), generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
        q4 = quantize_weight_int4(w)
        x = torch.randn((1, k), generator=gen, device=DEVICE).to(torch.bfloat16)
        got = m4.int4_matmul(x, q4["w_p4"], q4["scale4"])
        err, ratio = int4_error(got, m4.int4_matmul_plain(x, q4["w_p4"], q4["scale4"]), x,
                                m4.dequantize_weight4(q4, torch.bfloat16))
        q8 = quantize_weight(w)
        xq, xs = m8.quantize_rows(torch.randn((64, k), generator=gen,
                                              device=DEVICE).to(torch.bfloat16))
        w8 = to_kmajor(q8["w_q"])
        same = torch.equal(m8.int8_matmul(xq, xs, w8, q8["scale"]),
                           m8.int8_matmul_plain(xq, xs, w8, q8["scale"]))
        rows.append(dict(leaf=name, K=k, N=nn, int4_limit_ratio=ratio, int4_max_abs_err=err,
                         int8_bit_identical=bool(same)))
    return rows


def child_sharded(spec):
    """One of 12b's processes: a tp rank on the card (gloo: NCCL takes one
    rank a device), its shards of the live_place weights built in turns
    with the other process; the velocity, logits and VQA answer of
    `shard_paths`, the control (rank 1's o partial sums dropped), then B4
    and B5 at their local shard shapes: an int4 engine's decode steps and
    a w8a8 engine's gen block through the kernels (its velocity, and the
    control's with each rank's own activation scale, `OwnScale`), and each
    kernel against its plain version on this rank's layer-0 leaves."""
    import torch.distributed as dist

    from bagel_tpu_torch import configs
    from bagel_tpu_torch.data.tokenizer import MockTokenizer
    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.models import qwen2
    from bagel_tpu_torch.models.bagel import init_bagel_params
    from bagel_tpu_torch.ops import int4_matmul as m4
    from bagel_tpu_torch.ops import int8_matmul as m8
    from bagel_tpu_torch.parallel.mesh import InferenceLayout, make_mesh
    from bagel_tpu_torch.utils.quant import quantize_bagel_params

    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    cuda = DEVICE == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    cfg = getattr(configs, SHARD_CFG)()
    L = cfg.llm.num_hidden_layers
    tok = MockTokenizer(cfg.llm.vocab_size)
    layout = InferenceLayout(make_mesh((1, 1, SHARD_TP)), cfg)
    for turn in range(dist.get_world_size()):  # one process draws at a time
        if turn == rank:
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            params = init_bagel_params(gen, cfg, torch.bfloat16 if cuda else torch.float32,
                                       device=DEVICE, place=live_place(gen, cfg, layout.place))
            if cuda:
                gc_cuda()
        dist.barrier()
    llm_gb = sum(t.numel() * t.element_size() for t in leaves(params["llm"])) / 1e9
    res = dict(rank=rank, llm_gb=llm_gb)
    x1, image = shard_inputs(cfg)
    with flash_int8(False):
        engine = BagelEngine(params, cfg, tok, tok.new_token_ids, max_kv=MAX_KV, device=DEVICE,
                             layout=layout)
        t0 = time.perf_counter()
        read = counts_reset()
        vel, logits, answer, _ = shard_paths(engine, x1, image)
        res.update(answer=answer, counts=read(), paths_s=time.perf_counter() - t0)
        tp, layout.tp = layout.tp, DropPartial(layout.tp, 1)
        control = gen_block_velocity(engine, prompt_contexts(engine), x1, L, "auto")
        layout.tp = tp
        if rank == 0:
            res["tensors"] = spec["out"] + ".pt"
            torch.save(dict(velocity=vel.cpu(), logits=logits.cpu(), control=control.cpu()),
                       res["tensors"])
        del engine, vel, control, logits

        # B4 at its local shapes: int4 groups lie along the input rows, so
        # this rank's shard quantized is the whole leaf's quantization cut
        q = quantize_bagel_params(params, "int4")
        q["llm"] = qwen2.fuse_llm_params(q["llm"], inplace=True)
        qeng = BagelEngine(q, cfg, tok, tok.new_token_ids, max_kv=MAX_KV, device=DEVICE,
                           layout=layout)
        ctx = qeng.update_context_text(QUESTION, qeng.init_context())
        read = counts_reset()
        qeng.gen_text(ctx, max_length=SHARD_DECODE, graph=False)
        res["int4_counts"] = read()
        x_gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
        rows = []
        for group, name in (("attn", "qkv"), ("attn", "o"), ("mlp", "gate_up"), ("mlp", "down")):
            leaf = {k: t[0] for k, t in q["llm"]["layers"][group][name].items()}
            x = torch.randn((1, leaf["w_p4"].shape[0] * 2), generator=x_gen,
                            device=DEVICE).to(torch.bfloat16)
            got = m4.int4_matmul(x, leaf["w_p4"], leaf["scale4"])
            want = m4.int4_matmul_plain(x, leaf["w_p4"], leaf["scale4"])
            err, ratio = int4_error(got, want, x,
                                    m4.dequantize_weight4(leaf, torch.bfloat16))
            n0 = m4.int4_matmul.launches
            qwen2._linear(x, leaf, width=layout.tp.widths.get(name))
            rows.append(dict(leaf=name, K=x.shape[1], N=got.shape[1], max_abs_err=err,
                             limit_ratio=ratio,
                             linear_launches=m4.int4_matmul.launches - n0))
        res["int4_rows"] = rows
        del qeng, q, ctx
        if rank == 0:  # B4 and B5 at tp = 4's local shapes too (odd group counts)
            res["tp4_rows"] = tp4_kernel_rows(cfg, x_gen)

        # B5 at its local shapes: a w8a8 engine's gen block, and the kernel
        # bit for bit on this rank's k-major layer-0 leaves
        q = quantize_bagel_params(params, "w8a8")
        whole_leaf_w8a8(q, params, layout)
        q["llm"] = qwen2.fuse_llm_params(q["llm"], inplace=True)
        qeng = BagelEngine(q, cfg, tok, tok.new_token_ids, max_kv=MAX_KV, device=DEVICE,
                           layout=layout)
        ctxs = prompt_contexts(qeng)
        read, coll = counts_reset(), collectives_reset()
        w8 = {L: gen_block_velocity(qeng, ctxs, x1, L, "auto").cpu()}
        res["w8a8_counts"], res["w8a8_collectives"] = read(), coll()
        w8[1] = gen_block_velocity(qeng, ctxs, x1, 1, "auto").cpu()
        tp, layout.tp = layout.tp, OwnScale(layout.tp)
        w8.update({("control", d): gen_block_velocity(qeng, ctxs, x1, d, "auto").cpu()
                   for d in (1, L)})
        layout.tp = tp
        if rank == 0:
            res["w8a8_tensors"] = spec["out"] + ".w8a8.pt"
            torch.save(w8, res["w8a8_tensors"])
        del w8
        rows = []
        for group, name in (("attn", "qkv"), ("attn", "o"), ("mlp", "gate_up"), ("mlp", "down")):
            leaf = {k: t[0] for k, t in q["llm"]["layers"][group][name].items()}
            x = torch.randn((64, leaf["w_q8"].shape[0]), generator=x_gen,
                            device=DEVICE).to(torch.bfloat16)
            xq, xs = m8.quantize_rows(x)
            got = m8.int8_matmul(xq, xs, leaf["w_q8"], leaf["scale"], leaf.get("b"))
            want = m8.int8_matmul_plain(xq, xs, leaf["w_q8"], leaf["scale"], leaf.get("b"))
            rows.append(dict(leaf=name, M=64, K=x.shape[1], N=got.shape[1],
                             bit_identical=bool(torch.equal(got, want))))
        res["w8a8_rows"] = rows
        del qeng, q, ctxs
    dist.barrier()
    dist.destroy_process_group()
    return res


def shard_reference():
    """One process's engine on 12b's and 12c's live_place weights: the
    velocity, logits and greedy VQA answer of `shard_paths`, and the
    answer's margins (`answer_margins`); then the same weights quantized
    w8a8, its gen block's velocity."""
    from bagel_tpu_torch import configs
    from bagel_tpu_torch.data.tokenizer import MockTokenizer
    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.models import qwen2
    from bagel_tpu_torch.models.bagel import init_bagel_params
    from bagel_tpu_torch.utils.quant import quantize_bagel_params

    cfg = getattr(configs, SHARD_CFG)()
    tok = MockTokenizer(cfg.llm.vocab_size)
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_bagel_params(gen, cfg, torch.bfloat16 if DEVICE == "cuda" else torch.float32,
                               device=DEVICE, place=live_place(gen, cfg))
    x1, image = shard_inputs(cfg)
    with flash_int8(False):
        engine = BagelEngine(params, cfg, tok, tok.new_token_ids, max_kv=MAX_KV, device=DEVICE)
        vel, logits, answer, ctx = shard_paths(engine, x1, image)
        margins = answer_margins(engine, ctx, answer)
        ref = dict(velocity=vel.cpu(), logits=logits.cpu(), answer=answer, margins=margins,
                   eos=tok.new_token_ids["eos_token_id"])
        del engine, ctx, vel, logits
        gc_cuda()
        # the w8a8 engine's gen block on the same weights (12b holds its tp = 2
        # one) at one layer and all, and at all through the plain attention:
        # how far a reordering alone moves it there
        q = quantize_bagel_params(params, "w8a8")
        del params
        q["llm"] = qwen2.fuse_llm_params(q["llm"], inplace=True)
        qeng = BagelEngine(q, cfg, tok, tok.new_token_ids, max_kv=MAX_KV, device=DEVICE)
        ctxs, L = prompt_contexts(qeng), cfg.llm.num_hidden_layers
        ref["w8a8_velocity"] = {d: gen_block_velocity(qeng, ctxs, x1, d, "auto").cpu()
                                for d in (1, L)}
        ref["w8a8_reorder"] = relative_error(
            gen_block_velocity(qeng, ctxs, x1, L, "dense").cpu(), ref["w8a8_velocity"][L])
        del qeng, q, ctxs
    ref["s"] = time.perf_counter() - t0
    gc_cuda()
    return ref


def shard_gates(label, procs, ref, control=True):
    """The lead process's velocity, logits and answer against one process's
    (`ref`): the velocity within FORWARD_TOL, the logits within LOGITS_TOL,
    the answer equal or parting where one process's logits hold a near tie
    of both tokens (the partial sums' fp32 order may flip it); every rank's
    answer equal; with `control`, rank 1's o partial sums dropped must fail
    the velocity's gate. Returns the gaps."""
    lead = procs[0]
    got = torch.load(lead["tensors"])
    rel = relative_error(got["velocity"], ref["velocity"])
    lrel = relative_error(got["logits"], ref["logits"])
    check(all(p["answer"] == lead["answer"] for p in procs), f"{label}: the ranks' answers differ")
    check(rel <= FORWARD_TOL, f"{label}: velocity rel err {rel:.3e} > {FORWARD_TOL}")
    check(lrel <= LOGITS_TOL, f"{label}: first decode step logits rel err {lrel:.3e} > {LOGITS_TOL}")
    out = dict(velocity_rel=rel, logits_rel=lrel, answer_parts=None)
    if control:
        out["control_rel"] = ctl = relative_error(got["control"], ref["velocity"])
        check(ctl > FORWARD_TOL, f"{label}: the control (rank 1's o partial sums dropped) passes "
                                 f"the gate: rel err {ctl:.3e} <= {FORWARD_TOL}")
    part = first_difference(lead["answer"], ref["answer"])
    if part is not None:
        mine = lead["answer"].split()
        got_tok = int(mine[part]) if part < len(mine) else ref["eos"]
        top1, top2, gap = ref["margins"][part]
        out["answer_parts"] = dict(token=part, got=got_tok, top2=[top1, top2], gap=gap)
        check(got_tok in (top1, top2) and gap <= NEAR_TIE,
              f"{label}: the VQA answer parts from one process's at token {part} ({got_tok}), "
              f"where one process's top two are {top1}, {top2}, {gap:.3e} std apart (a near "
              f"tie: <= {NEAR_TIE})")
    return out


def answer_text(out, ref):
    tie = out["answer_parts"]
    if tie is None:
        return "equal to one process's"
    return (f"parts from one process's at token {tie['token']} of "
            f"{len(ref['answer'].split())}, a near tie there ({tie['gap']:.2e} std between its "
            f"top two; {NEAR_TIE} allowed)")


def sharded_tp2(card, ref):
    """12b: tp = 2 on the one card, two processes over gloo (`child_sharded`),
    held against one process's engine on the same weights (`ref`,
    `shard_gates`: with the control); B4 and B5 launched at their local
    shard shapes per their formulas and held against their plain versions
    there; the w8a8 gen block's velocity against one process's w8a8 (each
    row quantized with its whole row's scale: the row-parallel leaves'
    absmax all-reduced with MAX) after one layer and after all, the
    control with each rank's own scale failing the one-layer gate, and its
    all-reduces by formula."""
    from bagel_tpu_torch import configs

    L = getattr(configs, SHARD_CFG)().llm.num_hidden_layers
    t0 = time.perf_counter()
    procs = run_children("sharded", [dict(kind="sharded", local_rank=0)] * SHARD_TP)
    wall = time.perf_counter() - t0
    lead = procs[0]
    out = shard_gates(f"12b tp = {SHARD_TP}", procs, ref)
    n4 = L * 4 * SHARD_DECODE  # 4 linears a layer, one whole chunk of steps
    n5 = L * 8  # the gen block: both experts' 4 linears a layer
    # of which o and down (L x 2 x 2) are row-parallel: their rows' absmax,
    # MAX over tp, the codes with the whole row's scale, B5's f32 instance
    n_row = L * 4
    # the w8a8 velocity against one process's: after one layer within
    # FORWARD_TOL_1; after all, within FORWARD_TOL or, where larger, what the
    # plain attention's reordering alone moves one process's (w8a8 codes
    # amplify reorderings: phase 7's gate does the same)
    w8 = torch.load(lead["w8a8_tensors"])
    w8_rel, w8_ctl, w8_tol = {}, {}, {1: FORWARD_TOL_1, L: max(FORWARD_TOL, ref["w8a8_reorder"])}
    for d in (1, L):
        w8_rel[d] = relative_error(w8[d], ref["w8a8_velocity"][d])
        w8_ctl[d] = relative_error(w8[("control", d)], ref["w8a8_velocity"][d])
        check(w8_rel[d] <= w8_tol[d], f"12b tp = {SHARD_TP}: the w8a8 gen block's velocity at "
                                      f"{d} layer(s), rel err {w8_rel[d]:.3e} against one "
                                      f"process's > {w8_tol[d]:.3e}")
    # the control (each rank's own scale) must fail after one layer, where
    # nothing amplifies it
    check(w8_ctl[1] > w8_tol[1], f"12b tp = {SHARD_TP}: the w8a8 control (each rank's own "
                                 f"scale) passes the one-layer gate: rel err {w8_ctl[1]:.3e} <= "
                                 f"{w8_tol[1]:.1e}")
    out.update(w8a8_velocity_rel=w8_rel, w8a8_control_rel=w8_ctl, w8a8_tol=w8_tol,
               w8a8_reorder_rel=ref["w8a8_reorder"])
    want5 = bf16_counts(b1=L, b5=n5, b5_f32=n_row, quant=n5 - n_row, absmax=n_row,
                        quant_given=n_row)  # B1: the block's attention, a layer
    for p in procs:
        check(p["counts"]["b4"] == p["counts"]["b5"] == 0, "12b: the bf16 paths ran B4 or B5")
        check(p["int4_counts"]["b4"] == n4, f"12b rank {p['rank']}: B4 launched "
              f"{p['int4_counts']['b4']} times in {SHARD_DECODE} decode steps, not {n4}")
        check(p["w8a8_counts"] == want5,
              f"12b rank {p['rank']}: the w8a8 gen block's launches {p['w8a8_counts']} != "
              f"{want5}")
        # the embedding's sum, o's and down's partial sums a layer, and a MAX
        # of the rows' absmax for each row-parallel linear
        c = p["w8a8_collectives"]["all_reduce"]
        check(c == dict(eager=1 + 2 * L + n_row, captured=0),
              f"12b rank {p['rank']}: the w8a8 gen block's all-reduces {c}, not "
              f"{1 + 2 * L + n_row} eager")
        for r in p["int4_rows"]:
            check(r["limit_ratio"] <= 1.0 and r["linear_launches"] == 1,
                  f"12b rank {p['rank']}: B4 at {r}")
        for r in p["w8a8_rows"]:
            check(r["bit_identical"], f"12b rank {p['rank']}: B5 at {r}")
    for r in lead["tp4_rows"]:
        check(r["int4_limit_ratio"] <= 1.0 and r["int8_bit_identical"],
              f"12b: B4 / B5 at tp = 4's local shape {r}")
    out.update(reference_s=ref["s"], wall_s=wall, llm_gb=[p["llm_gb"] for p in procs],
               paths_s=[p["paths_s"] for p in procs], int4_rows=lead["int4_rows"],
               w8a8_collectives=lead["w8a8_collectives"],
               w8a8_rows=lead["w8a8_rows"], tp4_rows=lead["tp4_rows"],
               launches=dict(sharded_tp2_int4=lead["int4_counts"],
                             sharded_tp2_w8a8=lead["w8a8_counts"],
                             sharded_tp2_bf16=lead["counts"]))
    log(f"[sharded] 12b tp = {SHARD_TP} on one card ({card}), two processes over gloo, "
        f"{out['llm_gb'][0]:.2f} GB of LLM weights each: the gen block's velocity ({FORWARD_PX} "
        f"px, {L} layers) rel err {out['velocity_rel']:.3e} (tol {FORWARD_TOL}), the control "
        f"(rank 1's o partial sums dropped) {out['control_rel']:.3e} (must exceed it); the first "
        f"decode step's logits {out['logits_rel']:.3e} (tol {LOGITS_TOL}); the {SHARD_VQA_PX} px "
        f"VQA's greedy answer {answer_text(out, ref)}; B4 {lead['int4_counts']['b4']} launches in "
        f"{SHARD_DECODE} int4 decode steps at the local shapes "
        f"{[(r['leaf'], r['K'], r['N']) for r in lead['int4_rows']]} (limit ratios "
        f"{[round(r['limit_ratio'], 3) for r in lead['int4_rows']]}), B5 "
        f"{lead['w8a8_counts']['b5']} in a w8a8 gen block, bit-identical at "
        f"{[(r['leaf'], r['K'], r['N']) for r in lead['w8a8_rows']]}; at tp = 4's local shapes "
        f"{[(r['leaf'], r['K'], r['N']) for r in lead['tp4_rows']]} B4's limit ratios "
        f"{[round(r['int4_limit_ratio'], 3) for r in lead['tp4_rows']]}, B5 bit-identical; the w8a8 "
        f"gen block's velocity against one process's w8a8 rel err {w8_rel[1]:.3e} at 1 layer "
        f"(tol {w8_tol[1]:.1e}), {w8_rel[L]:.3e} at {L} (tol {w8_tol[L]:.3e}; one process's "
        f"plain attention alone {ref['w8a8_reorder']:.3e}), the control (each rank's own "
        f"scale) {w8_ctl[1]:.3e} (must exceed the one-layer tol) / {w8_ctl[L]:.3e}, launches "
        f"{lead['w8a8_counts']}, "
        f"all-reduces {lead['w8a8_collectives']['all_reduce']}; the paths "
        f"{out['paths_s'][0]:.1f} s a process; one process's reference {ref['s']:.1f} s; "
        f"{wall:.1f} s with both processes' set-up")
    return out


def child_sharded_cards(spec):
    """One of 12c's processes: tp rank LOCAL_RANK on its own card through
    nccl, its shards of the live_place weights; `shard_paths` with the
    VQA's decode through the decode program's graphs (the tp all-reduces
    captured), then the 8-slot runtime's chats (the chunk's time)."""
    import torch.distributed as dist

    from bagel_tpu_torch import configs
    from bagel_tpu_torch.data.tokenizer import MockTokenizer
    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.models.bagel import init_bagel_params
    from bagel_tpu_torch.parallel.mesh import InferenceLayout, make_mesh

    cuda = DEVICE == "cuda"
    if cuda:
        local = int(os.environ["LOCAL_RANK"])
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method="env://", device_id=torch.device("cuda", local))
    else:  # a rehearsal on the CPU
        dist.init_process_group("gloo", init_method="env://")
    n, rank = dist.get_world_size(), dist.get_rank()
    cfg = getattr(configs, SHARD_CFG)()
    L = cfg.llm.num_hidden_layers
    tok = MockTokenizer(cfg.llm.vocab_size)
    layout = InferenceLayout(make_mesh((1, 1, n)), cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_bagel_params(gen, cfg, torch.bfloat16 if cuda else torch.float32,
                               device=DEVICE, place=live_place(gen, cfg, layout.place))
    if cuda:
        gc_cuda()
    engine = BagelEngine(params, cfg, tok, tok.new_token_ids, max_kv=MAX_KV, device=DEVICE,
                         layout=layout)
    x1, image = shard_inputs(cfg)
    res = dict(rank=rank)
    log(f"[12c rank {rank}] weights placed")
    with flash_int8(False):
        vel = gen_block_velocity(engine, prompt_contexts(engine), x1, L, "auto")
        ctx = vqa_context(engine, image)
        logits = first_logits(engine, ctx, "auto")
        log(f"[12c rank {rank}] velocity and first logits")
        read, coll = counts_reset(), collectives_reset()
        caps0 = engine.decode.captures
        res["answer"] = engine.gen_text(ctx, max_length=MAX_THINK)
        res.update(counts=read(), collectives=coll(), captures=engine.decode.captures - caps0,
                   nccl_kernels_replayed=nccl_replayed())
        log(f"[12c rank {rank}] the VQA's decode through the program")
        if rank == 0:
            res["tensors"] = spec["out"] + ".pt"
            torch.save(dict(velocity=vel.cpu(), logits=logits.cpu()), res["tensors"])
        del vel, logits, ctx
        run = queued_answers(engine, serve_chats(), 0)
        log(f"[12c rank {rank}] the runtime's chats")
        res["serve"] = {k: v for k, v in run.items() if k != "answers"}
        res["serve_answers"] = run["answers"]
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    # the decode graphs hold nccl's communicator: they go before the group
    # (destroying it under them waited forever on four cards)
    del engine, run
    release_graphs()
    dist.barrier()
    dist.destroy_process_group()
    return res


def release_graphs():
    """Free what is unreferenced, the decode programs' CUDA graphs with it,
    and wait for the card."""
    import gc

    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def sharded_cards(card, ref, plain_chunk_ms=None):
    """12c: tp over every card of the machine through nccl, the decode
    programs' graphs holding the all-reduces, held against one process's
    engine (`ref`, `shard_gates` without the control); launch and captured
    collective counts against their formulas; the 8-slot chunk's time
    (beside `plain_chunk_ms`, one card's, where 12a measured it)."""
    from bagel_tpu_torch import configs

    n = torch.cuda.device_count()
    L = getattr(configs, SHARD_CFG)().llm.num_hidden_layers
    per_forward = 2 * L + 1
    t0 = time.perf_counter()
    procs = run_children("sharded_cards", [dict(kind="sharded_cards", local_rank=r)
                                           for r in range(n)])
    wall = time.perf_counter() - t0
    lead = procs[0]
    label = f"12c tp = {n} over {n} cards"
    out = shard_gates(label, procs, ref, control=False)
    check(all(p["serve_answers"] == lead["serve_answers"] for p in procs),
          f"{label}: the ranks' served answers differ")
    steps = min(len(lead["answer"].split()) + 1, MAX_THINK)
    run = program_steps(steps, 16)
    caps = lead["captures"]
    want = bf16_counts(b1=L * (caps + run))
    check(lead["counts"] == want, f"{label}: the VQA decode's launches {lead['counts']} != {want}")
    c = lead["collectives"]
    check(c["all_reduce"]["captured"] == per_forward * caps * min(16, MAX_THINK),
          f"{label}: captured all-reduces {c}")
    chunk = lead["serve"]["chunk_ms_min"]
    out.update(wall_s=wall, captures=caps, collectives=c,
               nccl_kernels_replayed=lead["nccl_kernels_replayed"], chunk_ms=chunk,
               step_ms=chunk / SERVE_CHUNK, peak_gib=[p["peak_gib"] for p in procs],
               launches={f"sharded_tp{n}_vqa_decode": lead["counts"]})
    log(f"[sharded] {label} through nccl ({card} each): velocity rel err "
        f"{out['velocity_rel']:.3e}, first logits {out['logits_rel']:.3e}, the VQA answer (decode "
        f"program, {caps} capture(s)) {answer_text(out, ref)}; launches {lead['counts']}, "
        f"collectives {c}, {lead['nccl_kernels_replayed']} NCCL kernels in the replays; the "
        f"8-slot runtime: a {SERVE_CHUNK}-step chunk {chunk:.1f} ms at best ({chunk / SERVE_CHUNK:.2f}"
        f" ms a step" + (f"; one card, 12a: {plain_chunk_ms:.1f} ms" if plain_chunk_ms else "")
        + f"); peak {max(out['peak_gib']):.2f} GiB a card; {wall:.1f} s with set-up")
    return out


def phase_sharded(card, t2i=None, vqa=None):
    """Phase 12: sharded inference. 12a (`sharded_world1`), one process's
    reference on live_place weights (`shard_reference`), 12b
    (`sharded_tp2`), and 12c (`sharded_cards`) where the machine has two
    cards or more (a line says when it has fewer)."""
    t0 = time.perf_counter()
    out = dict(world1=sharded_world1(card, t2i, vqa))
    ref = shard_reference()
    out["tp2"] = sharded_tp2(card, ref)
    launches = dict(out["world1"].pop("launches"), **out["tp2"].pop("launches"))
    if torch.cuda.device_count() >= 2:
        out["cards"] = sharded_cards(card, ref, out["world1"]["serve"]["bf16"]["plain_chunk_ms"])
        launches.update(out["cards"].pop("launches"))
    else:
        log(f"[sharded] 12c needs two cards or more ({torch.cuda.device_count()} on the "
            f"machine): tp over cards through nccl not run")
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = launches
    log(f"[sharded] phase 12: {out['wall_s']:.1f} s")
    return out


def gc_cuda():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_all_kernels():
    """Phase 3 (3a-3e) on the smoke's configuration: (cfg, tokenizer, and
    each sub-phase's result)."""
    from bagel_tpu_torch.configs import BagelConfig
    from bagel_tpu_torch.data.tokenizer import MockTokenizer
    from bagel_tpu_torch.inference.engine import _bucket

    cfg = BagelConfig()  # BAGEL-7B-MoT widths + SigLIP so400m, both paths
    tok = MockTokenizer(cfg.llm.vocab_size)
    prompt_len = len(tok.encode(PROMPT)) + 2
    n_patches = (VQA_PX // cfg.vit.patch_size) ** 2
    q_len = len(tok.encode(QUESTION)) + 2
    vqa_shapes = dict(vit_t=_bucket(n_patches + 2), vit_valid=n_patches + 2,
                      q_len=q_len, q_t=_bucket(q_len))
    edit_px = edit_image_px()
    vit_patches = (edit_px // cfg.vit.patch_size) ** 2
    edit_shapes = dict(vae_t=n_latents(cfg, edit_px) + 2, vit_valid=vit_patches + 2,
                       vit_t=_bucket(vit_patches + 2), q_len=len(tok.encode(EDIT)) + 2)
    return (cfg, tok,
            phase_kernels(cfg, prompt_len, _bucket(prompt_len), vqa_shapes, edit_shapes,
                          serve_admission(cfg, tok)),
            phase_sparse_kernels(vqa_shapes["vit_t"] - 2, n_patches,
                                 cfg.vit.num_attention_heads, cfg.vit.head_dim),
            phase_int8_matmul(cfg, _bucket(prompt_len)),
            phase_quantize_rows(cfg),
            phase_split_rows(cfg),
            phase_int4_matmul(cfg),
            phase_flash_q8(cfg, prompt_len, _bucket(prompt_len), vqa_shapes),
            phase_kv8(cfg))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        return child_main(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    import bagel_tpu_torch  # noqa: F401  (outside a checkout: fails before any output)

    name, card = phase_device()
    phase_build()

    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.models.bagel import init_bagel_params

    cfg, tok, (worst, shapes), (worst3, main3), b5_rows, quant_rows, split_q, \
        (worst4, b4_rows, b4_token), (worst2, b2_rows, prep_rows), \
        (worst_kv8, kv8_main) = phase_all_kernels()

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_bagel_params(gen, cfg, torch.bfloat16, device=DEVICE)
    live_weights(params, cfg, gen)
    torch.cuda.synchronize()
    gc_cuda()  # the draws' segments go before the engine's buffers can land in them
    n_params = sum(t.numel() for t in leaves(params["llm"]))
    n_vit = sum(t.numel() for t in leaves(params["vit"]))
    log(f"[model] full-width BAGEL-7B-MoT, {cfg.llm.num_hidden_layers} layers, "
        f"{n_params / 1e9:.2f} B LLM params, SigLIP {cfg.vit.num_hidden_layers} layers, "
        f"{n_vit / 1e9:.3f} B params, bf16, built in {time.perf_counter() - t0:.1f} s")
    engine = BagelEngine(params, cfg, tok, tok.new_token_ids, max_kv=MAX_KV, device=DEVICE)
    with flash_int8(False):
        phase_forward(engine, gen)
        phase_vit_forward(engine)
        t2i = phase_t2i(engine, gen)
        vqa = phase_vqa(engine, card)
        taylorseer = phase_taylorseer(engine, t2i)
        edit = phase_edit(engine, card)
        batch = phase_batch(engine, t2i)
    w8a8 = phase_t2i_w8a8(engine, gen)
    int4 = phase_vqa_int4(engine, card)
    with flash_int8(False):
        serve = phase_serve(engine, card)
        program = phase_decode_program(engine, card, vqa)
        evals = phase_eval(engine, card)
    del engine, params  # phase 10 builds its own fp32 model
    gc_cuda()
    check(torch.cuda.memory_allocated() < 2**30,
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated before phase 10")
    train = phase_train(card)
    par = phase_parallel(card, train)
    sharded = phase_sharded(card, t2i, vqa)

    main_shape = shapes[0]
    decode = next(r for r in shapes if r["T"] == 1)
    quant_main = quant_rows[0]
    split_main = next(r for r in split_q if r["leaf"] == "down" and "absmax_device_ms" in r)
    library = "torch.nn.functional.scaled_dot_product_attention (bool mask, enable_gqa)"
    gate = next(r for r in b5_rows if r["shape"] == "gen gate")
    b2_main, prep_main = b2_rows[0], prep_rows[0]
    bwd_main = train["shape"]["backward"]
    from bagel_tpu_torch.ops.flash import Q8_BLOCK_K

    def by_path(key):
        return dict(t2i=t2i["launches"] if key == "b1" else 0,
                    vqa=dict(b1=vqa["b1"], b3=vqa["b3"]).get(key, 0),
                    t2i_taylorseer_50=taylorseer["taylorseer"]["launches"][key],
                    t2i_50=taylorseer["all full"]["launches"][key],
                    edit=edit["launches"][key], batch=batch["launches"][key],
                    t2i_w8a8=w8a8["launches"][key], vqa_int4=int4["launches"][key],
                    **{f"serve_{k}": counts[key] for k, counts in serve["launches"].items()},
                    **{k: counts[key] for k, counts in evals["launches"].items()},
                    train=train["timing"]["b3_launches"] if key == "b3" else 0,
                    **{k: counts[key] for k, counts in par["launches"].items()},
                    **{k: counts[key] for k, counts in sharded["launches"].items()})

    kernels = [
        dict(
            name="flash_cached_attention",
            route="cuda",
            source="bagel_tpu_torch/csrc/flash_cached_attention.cu",
            replaces="bagel_tpu/ops/flash.py:108",
            launches=sum(by_path("b1").values()),
            launches_by_path=by_path("b1"),
            max_abs_err=worst,
            tol=KERNEL_TOL,
            ms=main_shape["device_ms"],  # the kernel's time: its device time
            device_ms=main_shape["device_ms"],
            call_ms=main_shape["call_ms"],
            plain_ms=main_shape["plain_ms"],
            bound_ms=main_shape["bound_ms"],
            bound_by=main_shape["bound_by"],
            library_ms=main_shape["library_ms"],
            library=library,
            shape=main_shape["shape"],
            decode={key: decode[key] for key in ("shape", "past", "splits", "kernel_us",
                                                 "device_ms",
                                                 "call_ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by")},
            shapes=shapes,
        ),
        dict(
            name="flash_decode_kv8",
            route="cuda",
            source="bagel_tpu_torch/csrc/flash_cached_attention.cu",
            replaces="bagel_tpu/models/qwen2.py:446-452 (the decode attention over the int8 KV "
                     "cache: XLA fuses the int8 load and the scale multiply; no Pallas kernel)",
            launches=sum(by_path("kv8").values()),
            launches_by_path=by_path("kv8"),
            max_abs_err=worst_kv8,
            tol=KERNEL_TOL + ", against kv_dequantize + the plain attention; bit-identical to "
                             "B1's bf16 decode pair on the dequantized view",
            ms=kv8_main["device_ms"],  # the kernel's time: its device time (split + combine)
            device_ms=kv8_main["device_ms"],
            call_ms=kv8_main["call_ms"],
            plain_ms=kv8_main["plain_ms"],
            bound_ms=kv8_main["bound_ms"],
            bound_by=kv8_main["bound_by"],
            library_ms=None,
            library="none: no one PyTorch call computes it",
            shape=kv8_main["shape"],
            launch=f"{kv8_main['splits']} splits of 8 warps",
            bf16_pair_device_ms=kv8_main["bf16_pair_device_ms"],
        ),
        dict(
            name="sparse_packed_attention",
            route="cuda",
            source="bagel_tpu_torch/csrc/sparse_packed_attention.cu",
            replaces="bagel_tpu/ops/sparse_flash.py:97",
            launches=sum(by_path("b3").values()),
            launches_by_path=by_path("b3"),
            max_abs_err=worst3,
            tol=KERNEL_TOL + ", over the rows that see a key",
            ms=main3["device_ms"],  # the kernel's time: its device time
            device_ms=main3["device_ms"],
            call_ms=main3["call_ms"],
            plain_ms=main3["plain_ms"],
            bound_ms=main3["bound_ms"],
            bound_by=main3["bound_by"],
            library_ms=main3["library_ms"],
            library=library,
            shape=main3["shape"],
            tflops=main3["tflops"],
            train_shape={key: val for key, val in train["shape"].items()
                         if key not in ("backward", "vit_backward")},
        ),
        dict(
            name="sparse_packed_attention_bwd",
            route="cuda",
            source="bagel_tpu_torch/csrc/sparse_packed_attention_bwd.cu",
            replaces="bagel_tpu/ops/sparse_flash.py:264 (_bwd, sparse_packed_attention's "
                     "custom_vjp backward: XLA's recompute through chunked_packed_attention; "
                     "no Pallas kernel)",
            launches=sum(by_path("b3_bwd").values()),
            launches_by_path=dict(by_path("b3_bwd"), train=train["timing"]["b3_bwd_launches"]),
            kernels_a_launch="3 (Delta, dK/dV, dQ)",
            max_abs_err=max(max(r[f"{n}_max_abs_err"] for n in ("dq", "dk", "dv"))
                            for r in train["grad"]),
            tol=KERNEL_TOL + " for dq, dk, dv over the rows that see a key, against the plain "
                             f"autograd and the plain twin at S={GRAD_S}; at the training "
                             f"shapes ||err|| / ||ref|| <= {KERNEL_REL} against the chunked "
                             "recompute",
            ms=bwd_main["device_ms"],  # the kernels' time: their device time
            device_ms=bwd_main["device_ms"],
            call_ms=bwd_main["call_ms"],
            plain_ms=bwd_main["plain_ms"],
            bound_ms=bwd_main["bound_ms"],
            bound_by=bwd_main["bound_by"],
            library_ms=bwd_main["library_ms"],
            library="SDPA's backward under autograd (bool mask, enable_gqa), call time",
            shape=bwd_main["shape"],
            tflops=bwd_main["tflops"],
            peak_gib=bwd_main["peak_gib"],
            siglip_shape=train["shape"]["vit_backward"],
            gradient=train["grad"],
        ),
        dict(
            name="flash_cached_attention_q8",
            route="cuda",
            source="bagel_tpu_torch/csrc/flash_cached_attention_q8.cu",
            replaces="bagel_tpu/ops/flash.py:178",
            launches=sum(by_path("b2").values()),
            launches_by_path=by_path("b2"),
            max_abs_err=worst2,
            tol=KERNEL_TOL + f", against the plain version at the kernel's key tile "
                             f"({Q8_BLOCK_K})",
            ms=b2_main["device_ms"],  # the kernel's time: its device time
            device_ms=b2_main["device_ms"],
            call_ms=b2_main["call_ms"],
            plain_ms=b2_main["plain_ms"],
            bound_ms=b2_main["bound_ms"],
            bound_by=b2_main["bound_by"],
            library_ms=b2_main["library_ms"],
            library=library + " in bf16: another function (no int8 products)",
            shape=b2_main["shape"],
            shapes=b2_rows,
        ),
        dict(
            name="q8_prep",
            route="cuda",
            source="bagel_tpu_torch/csrc/flash_cached_attention_q8.cu",
            replaces="bagel_tpu/ops/flash.py:351-377 (B2's q/k/v quantization: XLA's work in "
                     "the JAX package, no Pallas kernel)",
            launches=sum(by_path("prep").values()),
            launches_by_path=by_path("prep"),
            max_abs_err=0.0,
            tol="bit-identical to the plain version (codes, V^T layout and scales)",
            ms=prep_main["device_ms"],  # the pass's time: its device time (two kernels)
            device_ms=prep_main["device_ms"],
            call_ms=prep_main["call_ms"],
            plain_ms=prep_main["plain_ms"],
            bound_ms=prep_main["bound_ms"],
            bound_by=prep_main["bound_by"],
            library_ms=None,
            library="none: no one PyTorch call computes it",
            shape=prep_main["shape"],
            shapes=prep_rows,
        ),
        dict(
            name="int4_matmul",
            route="cuda",
            source="bagel_tpu_torch/csrc/int4_matmul.cu",
            replaces="bagel_tpu/ops/int4_matmul.py:58",
            launches=sum(by_path("b4").values()),
            launches_by_path=by_path("b4"),
            max_abs_err=worst4,
            tol="|err| <= one bf16 ulp of plain + K 2^-24 sum|x w| (the f32 sums' order)",
            ms=b4_token["device_ms"],  # the kernel's time: its device time
            device_ms=b4_token["device_ms"],
            call_ms=b4_token["call_ms"],
            plain_ms=b4_token["plain_ms"],
            bound_ms=b4_token["bound_ms"],
            bound_by="bytes",
            library_ms=b4_token["library_ms"],
            library="torch.matmul on weights dequantized to bf16 beforehand",
            shape="one decode token: 112 launches (28 layers x qkv, o, gate_up, down), M=1, "
                  "each layer's own weights (cold in L2)",
            per_decode_token=b4_token,
            shapes=b4_rows,
        ),
        dict(
            name="int8_matmul",
            route="cuda",
            source="bagel_tpu_torch/csrc/int8_matmul.cu",
            replaces="bagel_tpu/ops/int8_matmul.py:49",
            launches=sum(by_path("b5").values()),
            launches_by_path=by_path("b5"),
            max_abs_err=0.0,
            tol="bit-identical to the plain version",
            ms=gate["device_ms"],  # the kernel's time: its device time
            device_ms=gate["device_ms"],
            call_ms=gate["call_ms"],
            plain_ms=gate["plain_ms"],
            bound_ms=gate["bound_ms"],
            bound_by=gate["bound_by"],
            library_ms=gate["library_ms"],
            library="torch._int_mm + the same f32 epilogue",
            shape=f"gate M={gate['M']} K={gate['K']} N={gate['N']}",
            shapes=b5_rows,
        ),
        dict(
            name="quantize_rows",
            route="cuda",
            source="bagel_tpu_torch/csrc/int8_matmul.cu",
            replaces="bagel_tpu/models/qwen2.py:146 (the w8a8 activation quantization: "
                     "XLA's work in the JAX package, no Pallas kernel)",
            launches=sum(by_path("quant").values()),
            launches_by_path=by_path("quant"),
            max_abs_err=0.0,
            tol="bit-identical to the plain version (codes and scales)",
            ms=quant_main["device_ms"],  # the kernel's time: its device time
            device_ms=quant_main["device_ms"],
            call_ms=quant_main["call_ms"],
            plain_ms=quant_main["plain_ms"],
            bound_ms=quant_main["bound_ms"],
            bound_by=quant_main["bound_by"],
            library_ms=None,
            library="none: no one PyTorch call computes it",
            shape=f"M={quant_main['M']} K={quant_main['K']}",
            shapes=quant_rows,
        ),
        dict(
            name="row_absmax",
            route="cuda",
            source="bagel_tpu_torch/csrc/int8_matmul.cu",
            replaces="bagel_tpu/models/qwen2.py:147 (the max of the w8a8 scale, over a row "
                     "that tp splits: XLA's reduction across the shards, no Pallas kernel)",
            launches=sum(by_path("absmax").values()),
            launches_by_path=by_path("absmax"),
            max_abs_err=0.0,
            tol="bit-identical to the plain version",
            ms=split_main["absmax_device_ms"],  # the kernel's time: its device time
            device_ms=split_main["absmax_device_ms"],
            call_ms=split_main["absmax_call_ms"],
            plain_ms=split_main["absmax_plain_ms"],
            bound_ms=split_main["absmax_bound_ms"],
            bound_by="bytes",
            library_ms=split_main["absmax_library_ms"],
            library="torch.linalg.vector_norm(x, inf, dim=-1) in f32",
            shape=split_main["shape"],
            shapes=split_q,
        ),
        dict(
            name="quantize_rows_given",
            route="cuda",
            source="bagel_tpu_torch/csrc/int8_matmul.cu",
            replaces="bagel_tpu/models/qwen2.py:148 (the w8a8 codes of a row that tp splits, "
                     "with the whole row's scale: XLA's work, no Pallas kernel)",
            launches=sum(by_path("quant_given").values()),
            launches_by_path=by_path("quant_given"),
            max_abs_err=0.0,
            tol="bit-identical to the plain version (codes)",
            ms=split_main["given_device_ms"],  # the kernel's time: its device time
            device_ms=split_main["given_device_ms"],
            call_ms=split_main["given_call_ms"],
            plain_ms=split_main["given_plain_ms"],
            bound_ms=split_main["given_bound_ms"],
            bound_by="bytes",
            library_ms=None,
            library="none: no one PyTorch call computes it",
            shape=split_main["shape"],
        ),
        dict(
            name="int8_matmul_f32",
            route="cuda",
            source="bagel_tpu_torch/csrc/int8_matmul.cu",
            replaces="bagel_tpu/ops/int8_matmul.py:49 (B5's f32 instance: a tp rank's partial "
                     "sum, rounded once after the all-reduce as JAX rounds the whole sum)",
            launches=sum(by_path("b5_f32").values()),
            launches_by_path=by_path("b5_f32"),
            max_abs_err=0.0,
            tol="bit-identical to the plain epilogue before its rounding",
            ms=split_main["b5_f32_device_ms"],  # the kernel's time: its device time
            device_ms=split_main["b5_f32_device_ms"],
            call_ms=split_main["b5_f32_call_ms"],
            plain_ms=split_main["b5_f32_plain_ms"],
            bound_ms=split_main["b5_f32_bound_ms"],
            bound_by=split_main["b5_f32_bound_by"],
            library_ms=split_main["b5_f32_library_ms"],
            library="torch._int_mm + the same f32 epilogue",
            shape=f"{split_main['shape']} N={cfg.llm.hidden_size}",
            bf16_instance_device_ms=split_main["b5_bf16_device_ms"],
        ),
    ]
    log(json.dumps({"vqa": vqa, "taylorseer": taylorseer, "edit": edit, "batch": batch,
                    "t2i_w8a8": w8a8, "vqa_int4": int4, "serve": serve,
                    "decode_program": program, "eval": evals, "train": train,
                    "parallel": {k: v for k, v in par.items() if k != "launches"},
                    "sharded": {k: v for k, v in sharded.items() if k != "launches"}}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
