#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bagel_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (the first failure exits non-zero, and no result line is printed):
  1. device  nvidia-smi's name and power limit, torch's device name; TF32 off
             for fp32 matmuls and convolutions (the VAE runs in full fp32).
  2. build   the kernel in bagel_tpu_torch/csrc with nvcc, for sm_90a.
  3. kernels the kernel against its plain PyTorch version in bf16: edge
             cases, then the shapes the main path gives it, with its time, the
             plain version's, one PyTorch library call's (a yardstick the port
             never calls) and the roofline bound of the work; and a negative
             control: the gate must reject an attention that takes past as 0.
  4. forward one full-width MoT gen-block forward (512 px, full depth)
             through the kernel and through the dense path: velocity rel. error.
  5. t2i     text-to-image through BagelEngine.__call__ at full width and depth
             (BAGEL-7B-MoT shapes, seeded random bf16 weights), 1024 px,
             8 timesteps; the kernel's launch count must be L x (2 + 7).
Then one JSON line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
SEED = 0
PROMPT = "A photo of a red fox sitting in fresh snow at sunrise, highly detailed"
PX = 1024
FORWARD_PX = 512
NUM_TIMESTEPS = 8  # timestep_shift 3: 6 steps with CFG (3 branches), 1 without
CFG = dict(cfg_text_scale=4.0, cfg_img_scale=1.5, timestep_shift=3.0,
           num_timesteps=NUM_TIMESTEPS)
MAX_KV = 8192
KERNEL = "flash_cached_attention"
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
PEAK_FLOPS = 989e12  # H100 SXM bf16 dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
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


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    name = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {smi.stdout.strip().splitlines()[0]}")
    log(f"[device] torch: {name}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return name


def phase_build() -> None:
    from bagel_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build(KERNEL)
    log(f"[build] {KERNEL} {'built' if report else 'cached'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {KERNEL}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
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


def bound_ms(flops, bytes_):
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, bytes_ / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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


def compare(flash, args, causal, label):
    q, k, v, past, valid = args
    got = flash.flash_cached_attention(q, k, v, past, valid, causal=causal)
    want = flash.flash_cached_attention_plain(q, k, v, past, valid, causal=causal)
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


def phase_kernels(cfg, prompt_len, prefill_t):
    from bagel_tpu_torch.ops import flash
    from bagel_tpu_torch.ops.attention import cache_block_mask

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
    ]
    for label, b, t, s, h, kh, past, valid, garbage in edge:
        for causal in (True, False):
            args = attention_inputs(gen, b, t, s, h, kh, past, valid, garbage)
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

    # the shapes the main path gives the kernel (28 heads over 4 KV heads,
    # D=128, an 8192-slot cache): 1024 px denoise with CFG (3 rows, the
    # cfg_text row has an empty cache), without CFG, and the prompt prefill
    n = (PX // cfg.latent_downsample) ** 2 + 2
    shapes = [
        ("denoise B=3 (CFG)", 3, n, [prompt_len, 0, prompt_len], [n] * 3, False),
        ("denoise B=1", 1, n, [prompt_len], [n], False),
        ("prefill", 1, prefill_t, [0], [prompt_len], True),
    ]
    results = []
    for label, b, t, past, valid, causal in shapes:
        args = attention_inputs(gen, b, t, MAX_KV, 28, 4, past, valid)
        got, want, err, ratio, rel = compare(flash, args, causal, label)
        worst = max(worst, err)
        q, k, v, p, vl = args
        if any(past):  # negative control: the gate rejects a plausible wrong kernel
            blind = flash.flash_cached_attention_plain(q, k, v, torch.zeros_like(p), vl,
                                                       causal=causal)
            b_err, b_ratio, b_rel = kernel_error(blind, want, valid)
            check(not within_tol(b_ratio, b_rel),
                  f"{label}: the gate accepts an attention that takes past as 0")
            log(f"[kernels] {label}: control that takes past as 0 is rejected: "
                f"max abs {b_err:.3e} ({b_ratio:.1f} x the elementwise limit), rel {b_rel:.3e}")
            del blind
        del got, want
        ms = cuda_ms(lambda: flash.flash_cached_attention(q, k, v, p, vl, causal=causal), 20, 3)
        plain_ms = cuda_ms(
            lambda: flash.flash_cached_attention_plain(q, k, v, p, vl, causal=causal), 2)
        mask = cache_block_mask(MAX_KV, t, p, vl, causal)[:, None]
        lib_ms = cuda_ms(sdpa_call(q, k, v, mask), 5)
        flops, bytes_ = attention_work(past, valid, t, 28, 4, 128, causal)
        bms, by = bound_ms(flops, bytes_)
        results.append(dict(shape=label, B=b, T=t, S=MAX_KV, past=past, causal=causal,
                            max_abs_err=err, limit_ratio=ratio, rel_err=rel, ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bms, bound_by=by, tflops=flops / ms / 1e9))
        log(f"[kernels] {label}: T={t} past={past} max abs err {err:.3e} ({ratio:.2f} x the "
            f"elementwise limit), rel err {rel:.3e}; "
            f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
            f"SDPA {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        del args, q, k, v, mask
        torch.cuda.empty_cache()
    return worst, results


# ---------------------------------------------------------------------------
# phases 4-5: the model
# ---------------------------------------------------------------------------


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def live_weights(params, cfg, gen):
    """Seeded random weights that hide no bug: the gen expert differs from
    the und expert, norms differ from 1, and llm2vae is non-zero (a zero
    velocity head would leave the latent on the noise)."""

    def noise(t, std):
        return torch.randn(t.shape, generator=gen, device=t.device) * std

    llm = params["llm"]
    for name, tree in llm["layers"].items():
        for t in leaves(tree):
            if bool((t == 1).all()):  # a norm weight
                t.copy_(1 + noise(t, 0.05))
            elif name.endswith("_gen"):
                t.add_(noise(t, 0.02).to(t.dtype))
    for name in ("final_norm", "final_norm_gen"):
        llm[name].copy_(1 + noise(llm[name], 0.05))
    w = params["llm2vae"]["w"]
    w.copy_(noise(w, cfg.llm.hidden_size ** -0.5).to(w.dtype))


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


def phase_forward(engine, gen):
    """One gen-block forward of the full MoT through the kernel (auto) and
    the dense path, on the same inputs; relative error of the velocity."""
    from bagel_tpu_torch.models import qwen2
    from bagel_tpu_torch.models.bagel import latent_to_llm

    cfg, params = engine.cfg, engine.params
    ctxs = prompt_contexts(engine)
    side = FORWARD_PX // cfg.latent_downsample
    n = side * side
    cache = stacked_cache(ctxs)
    b = len(ctxs)
    lat_pos = torch.as_tensor(engine._pos_ids(FORWARD_PX, FORWARD_PX, cfg.latent_downsample,
                                              cfg.max_latent_size), device=DEVICE)
    x1 = torch.randn((n, cfg.patch_latent_dim), generator=gen, device=DEVICE)
    lat = latent_to_llm(params, cfg, x1, torch.full((n,), 0.8, device=DEVICE), lat_pos)
    tok = qwen2.embed_tokens(params["llm"], engine._boundary_ids())
    block = torch.cat([tok, lat.to(tok.dtype)])[None].expand(b, n + 2, -1).contiguous()
    pos = torch.tensor([c.rope for c in ctxs], device=DEVICE)[:, None].expand(b, n + 2)
    valid = torch.full((b,), n + 2, dtype=torch.int32, device=DEVICE)
    head = params["llm2vae"]
    # depth 1 shows the error one attention leaves; full depth what the
    # random-weight stack makes of it
    for depth, tol in ((1, FORWARD_TOL_1), (cfg.llm.num_hidden_layers, FORWARD_TOL)):
        llm_cfg = dataclasses.replace(cfg.llm, num_hidden_layers=depth)
        vel = {}
        for impl in ("auto", "dense"):
            hidden, _ = qwen2.llm_extend(params["llm"], llm_cfg, block, pos, cache, valid,
                                         und_len=2, causal=False, update_cache=False,
                                         attn_impl=impl)
            vel[impl] = hidden[:, 2:].float() @ head["w"].float() + head["b"].float()
            del hidden
            torch.cuda.empty_cache()
        rel = relative_error(vel["auto"], vel["dense"])
        check(bool(torch.isfinite(vel["auto"]).all()), "forward: non-finite velocity")
        check(rel <= tol, f"forward: depth {depth} velocity rel err {rel:.3e} > {tol}")
        log(f"[forward] {FORWARD_PX} px gen block (T={n + 2}, B={b}), {depth} layer(s): "
            f"kernel vs dense velocity rel err {rel:.3e} (tol {tol})")


def phase_t2i(engine, gen):
    from bagel_tpu_torch.inference import engine as tengine
    from bagel_tpu_torch.models.bagel import unpatchify_latent
    from bagel_tpu_torch.models.vae import vae_decode
    from bagel_tpu_torch.ops import flash

    cfg = engine.cfg
    L = cfg.llm.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()

    # the main path, through the user entry point, counted
    flash.flash_cached_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine(text=PROMPT, understanding_output=False, image_shapes=(PX, PX),
                 rng=torch.Generator(device=DEVICE).manual_seed(SEED), **CFG)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = flash.flash_cached_attention.launches
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
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    import bagel_tpu_torch  # noqa: F401  (outside a checkout: fails before any output)

    name = phase_device()
    phase_build()

    from bagel_tpu_torch.configs import BagelConfig
    from bagel_tpu_torch.data.tokenizer import MockTokenizer
    from bagel_tpu_torch.inference.engine import BagelEngine, _bucket
    from bagel_tpu_torch.models.bagel import init_bagel_params

    cfg = BagelConfig(visual_und=False, vit=None)  # BAGEL-7B-MoT widths, no ViT
    tok = MockTokenizer(cfg.llm.vocab_size)
    prompt_len = len(tok.encode(PROMPT)) + 2
    worst, shapes = phase_kernels(cfg, prompt_len, _bucket(prompt_len))

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_bagel_params(gen, cfg, torch.bfloat16, device=DEVICE)
    live_weights(params, cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params["llm"]))
    log(f"[model] full-width BAGEL-7B-MoT, {cfg.llm.num_hidden_layers} layers, "
        f"{n_params / 1e9:.2f} B LLM params in bf16, built in {time.perf_counter() - t0:.1f} s")
    engine = BagelEngine(params, cfg, tok, tok.new_token_ids, max_kv=MAX_KV, device=DEVICE)
    phase_forward(engine, gen)
    launches = phase_t2i(engine, gen)

    main_shape = shapes[0]
    kernels = [dict(
        name=KERNEL,
        route="cuda",
        source="bagel_tpu_torch/csrc/flash_cached_attention.cu",
        replaces="bagel_tpu/ops/flash.py:108",
        launches=launches,
        max_abs_err=worst,
        tol=KERNEL_TOL,
        ms=main_shape["ms"],
        plain_ms=main_shape["plain_ms"],
        bound_ms=main_shape["bound_ms"],
        bound_by=main_shape["bound_by"],
        library_ms=main_shape["library_ms"],
        library="torch.nn.functional.scaled_dot_product_attention (bool mask, enable_gqa)",
        shape=main_shape["shape"],
        shapes=shapes,
    )]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
