"""Text-to-image through `BagelEngine.__call__`, a closed loop of one
client: the next image starts when the last has ended, while the window
lasts; the window closes when the last image it started ends.

The check follows the program step by step from its own state. A recorder
at the engine's `cfg_combine` (its call per job and denoise step) keeps
each step's combined velocity and, at the sampled steps, every CFG
branch's. From the request's noise and those velocities the latent of
every step is worked out again with the engine's Euler arithmetic; the
plain reference then computes the branch velocities at the sampled steps
from those latents and from the prompt (its own prefill), combines the
program's branches again, and decodes the final latent with its own VAE.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import program
from benchmark.harness.draws import rng
from benchmark.harness.tokens import prompt_ids, special
from benchmark.harness.weights import make_params
from benchmark.reference import bagel as ref
from benchmark.traffic import t2i_closed as traffic


class Recorder:
    """Wraps the engine module's `cfg_combine`: per image, each step's
    combined velocity, and the branch velocities at `sampled` steps. With
    `low` (the control) the combination runs in bfloat16."""

    def __init__(self, module, sampled, low=False):
        self.module, self.orig = module, module.cfg_combine
        self.sampled = set(sampled)
        self.low = low
        self.on = False
        self.steps, self.branches = [], {}
        module.cfg_combine = self

    def begin(self):
        self.on, self.steps, self.branches = True, [], {}

    def end(self):
        self.on = False
        return self.steps, self.branches

    def __call__(self, v_cond, v_text, v_img, *args, **kw):
        if self.low:
            low = [None if v is None else v.bfloat16() for v in (v_cond, v_text, v_img)]
            out = self.orig(*low, *args, **kw).float()
        else:
            out = self.orig(v_cond, v_text, v_img, *args, **kw)
        if self.on:
            k = len(self.steps)
            if k in self.sampled:
                self.branches[k] = (v_cond, v_text, v_img)
            self.steps.append(out)
        return out

    def remove(self):
        self.module.cfg_combine = self.orig


def schedule(p: dict):
    ts, dts = ref.shifted_timesteps(p["num_timesteps"], p["timestep_shift"])
    lo, hi = p["cfg_interval"]
    return ts, dts, (ts > lo) & (ts <= hi)


def setup(run) -> None:
    from bagel_tpu_torch.inference import engine as engine_mod

    p = run.traffic
    t = time.perf_counter()
    if run.device.type == "cuda":
        program.build_kernels()
    parts = run.state["setup_parts"] = {"build_s": time.perf_counter() - t}
    t = time.perf_counter()
    params = make_params(run.model, run.seed, run.device, run.dtype)
    parts["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    run.state["engine"] = program.engine(run, params)
    parts["engine_s"] = time.perf_counter() - t
    run.state["pool"] = traffic.draw(p, run.seed)
    ts, _, on = schedule(p)
    g = rng(run.seed, 9)
    on_i, off_i = np.nonzero(on)[0], np.nonzero(~on)[0]
    sampled = [0] + [int(g.choice(x)) for x in (on_i[1:], off_i) if len(x)]
    run.state["sampled"] = sorted(set(sampled))
    run.state["rec"] = Recorder(engine_mod, run.state["sampled"],
                                low=bool(run.state.get("quant")))
    # warm-up: every shape of the path (the longest prompt's prefill, the
    # three- and one-branch forwards, the VAE decode), fewer steps
    warm = dict(traffic.sampling(p), num_timesteps=p["warmup_timesteps"])
    longest = max(run.state["pool"], key=lambda r: len(r["prompt"]))
    gen = torch.Generator(device=run.device).manual_seed(1)
    t = time.perf_counter()
    run.state["engine"](text=longest["prompt"], rng=gen, **warm)
    parts["warmup_s"] = time.perf_counter() - t


def window(run) -> None:
    p, eng, rec = run.traffic, run.state["engine"], run.state["rec"]
    kw = traffic.sampling(p)
    pool = run.state["pool"]
    px = p["px"]
    run.t_start = t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < run.seconds:
        req = pool[i % len(pool)]
        if i == 0:
            run.tracer.start()
        gen = torch.Generator(device=run.device).manual_seed(req["noise_seed"])
        rec.begin()
        ts = time.perf_counter()
        entry = {"id": req["id"], "prompt": req["prompt"], "noise_seed": req["noise_seed"],
                 "t_send": ts}
        try:
            img = eng(text=req["prompt"], rng=gen, **kw)["image"]
            entry["ok"] = img is not None and img.shape == (px, px, 3)
            entry["image"] = img
        except Exception as e:  # noqa: BLE001  a failed image counts as failed
            entry["ok"], entry["error"] = False, repr(e)
        entry["t_done"] = time.perf_counter()
        entry["steps"], entry["branches"] = rec.end()
        if i == 0:
            run.tracer.stop()
            entry["traced"] = True
        run.log.append(entry)
        i += 1
    run.t_end = time.perf_counter()
    done = [e for e in run.log if e["ok"]]
    run.attempted, run.failed = len(run.log), len(run.log) - len(done)
    if done:
        run.values["t2i_image_s"] = run.window_s / len(done)


def free(run) -> None:
    run.state["rec"].remove()
    run.state.pop("engine", None)


def check(run) -> None:
    """velocity_gap: the widest relative gap of a branch velocity at the
    sampled steps; combine_gap: the program's combined velocity against the
    reference's combination of its branches; image_share: the share (%) of
    the image's values (pixels x channels) whose level differs from the
    reference's decode of the final latent."""
    p, lim = run.traffic, run.cell["limits"]
    done = [e for e in run.log if e["ok"]]
    if not done:
        return
    e = done[int(rng(run.seed, 10).integers(len(done)))]
    ref.fp32_mode()
    dev = run.device
    model = run.model
    params = make_params(model, run.seed, dev, run.dtype)
    ts, dts, on = schedule(p)
    if len(e["steps"]) != len(ts) or set(e["branches"]) != set(run.state["sampled"]):
        run.compare("steps_recorded", 1.0, 0.0)
        return
    down = 2 ** (len(model["vae"]["ch_mult"]) - 1) * model["latent_patch_size"]
    side = p["px"] // down
    pd = model["latent_patch_size"] ** 2 * model["vae"]["z_channels"]
    gen = torch.Generator(device=dev).manual_seed(e["noise_seed"])
    x = torch.randn((side * side, pd), generator=gen, dtype=torch.float32, device=dev)
    xs = {}
    for k, (v_t, dt) in enumerate(zip(e["steps"], dts)):
        if k in e["branches"]:
            xs[k] = x.clone()
        x = x - v_t * float(dt)  # the engine's Euler step, in its float32
    vocab = model["llm"]["vocab_size"]
    ids = special(vocab)
    ctx = prompt_ids(e["prompt"], vocab)
    lat_pos = ref.latent_positions(p["px"], p["px"], down, model["max_latent_size"], dev)
    vel, comb = 0.0, 0.0
    for k in sorted(e["branches"]):
        v_cond, v_text, v_img = e["branches"][k]
        with torch.no_grad():
            want_c = ref.gen_velocity(params, model, ctx, xs[k], float(ts[k]), lat_pos, ids)
            want = {"cond": want_c, "img": want_c}
            if on[k]:
                want["text"] = ref.gen_velocity(params, model, [], xs[k], float(ts[k]),
                                                lat_pos, ids)
        for name, got in (("cond", v_cond), ("text", v_text), ("img", v_img)):
            if on[k] and got is None:
                vel = float("inf")
            if got is not None:
                w = want.get(name)
                vel = max(vel, float("inf") if w is None else
                          float((got.float() - w).norm() / w.norm()))
        if on[k] and v_text is not None:
            c = ref.cfg_combine(v_cond.float(), v_text.float(),
                                None if v_img is None else v_img.float(),
                                p["cfg_text_scale"], p["cfg_img_scale"])
            got = e["steps"][k].float().reshape(c.shape)
            comb = max(comb, float((got - c).norm() / c.norm()))
    h = side
    z = ref.unpatchify(x.reshape(h * h, pd), h, h, model["latent_patch_size"],
                       model["vae"]["z_channels"])
    with torch.no_grad():
        img = ref.to_uint8(ref.vae_decode(params["vae"], model["vae"], z)).cpu().numpy()
    share = 100.0 * float(np.mean(img != e["image"]))
    run.compare("velocity_gap", vel, lim["velocity_gap"])
    run.compare("combine_gap", comb, lim["combine_gap"])
    run.compare("image_share", share, lim["image_share"])
    run.state["checked"] = {"id": e["id"], "steps": sorted(e["branches"])}
