"""The yardstick's arithmetic: peaks, the work of a kernel call and of a
model's tokens, counted from shapes. Kept here, so that a change to the
program cannot move them: `attention_work` and `bound_ms_at` are frozen
copies of `chip_smoke.py`'s; the model FLOPs count each token through its
one expert, as upstream's analytic count (pretrain_unified_navit.py:46-65)
and `bagel_tpu_torch/utils/metrics.py` do.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense, at its 700 W limit)
PEAK_BF16 = 989e12  # FLOP/s
PEAK_BYTES = 3.35e12  # HBM3 bytes/s


def attention_work(past, valid, t, h, kh, d, causal):
    """(FLOPs, bytes) one cached-attention call needs: two products over the
    visible (query, key) pairs; q and out once, the live K/V once (bf16)."""
    pairs = 0
    for p, n in zip(past, valid):
        n = min(n, t)
        pairs += n * p + (n * (n + 1) // 2 if causal else n * n)
    flops = 4 * d * h * pairs
    bytes_ = 2 * (2 * len(past) * t * h * d
                  + 2 * sum(p + min(n, t) for p, n in zip(past, valid)) * kh * d)
    return flops, bytes_


def bound_ms_at(ops, bytes_, peak=PEAK_BF16):
    """The least time for `ops` operations at `peak` per second and `bytes_`
    at the memory rate: (ms, what bounds it)."""
    t_ops, t_bytes = ops / peak * 1e3, bytes_ / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def layer_params(llm: dict) -> int:
    """Parameters of one expert's linears in one decoder layer."""
    d, f = llm["hidden_size"], llm["intermediate_size"]
    hd = d // llm["num_attention_heads"]
    qd, kvd = llm["num_attention_heads"] * hd, llm["num_key_value_heads"] * hd
    return d * (qd + 2 * kvd) + qd * d + 3 * d * f


def forward_flops(llm: dict, tokens: int, pairs: int, head: int = 0) -> int:
    """FLOPs of one inference forward: `tokens` through every layer (one
    expert each), attention over `pairs` visible (query, key) pairs a layer,
    and `head` output rows through a [hidden, head_width] matrix given as
    head's product (rows x width)."""
    L, d = llm["num_hidden_layers"], llm["hidden_size"]
    hd = d // llm["num_attention_heads"]
    return (2 * tokens * layer_params(llm) * L + 4 * hd * llm["num_attention_heads"] * pairs * L
            + 2 * d * head)


def siglip_flops(vit: dict, n: int) -> int:
    """FLOPs of one image of n patches through the tower (patch embed,
    layers, full attention)."""
    d, f, L = vit["hidden_size"], vit["intermediate_size"], vit["num_hidden_layers"]
    patch = 3 * vit["patch_size"] ** 2
    return 2 * n * (patch * d + L * (4 * d * d + 2 * d * f)) + 4 * d * n * n * L


def vae_decode_flops(vae: dict, h: int, w: int) -> int:
    """FLOPs of the decoder's convolutions and its mid attention for a
    latent of h x w (image 8h x 8w)."""
    ch, mult, nres, z = vae["ch"], tuple(vae["ch_mult"]), vae["num_res_blocks"], vae["z_channels"]
    total = 0

    def conv(cin, cout, k, hh, ww):
        return 2 * cin * cout * k * k * hh * ww

    def res(cin, cout, hh, ww):
        f = conv(cin, cout, 3, hh, ww) + conv(cout, cout, 3, hh, ww)
        return f + (conv(cin, cout, 1, hh, ww) if cin != cout else 0)

    bi = ch * mult[-1]
    total += conv(z, bi, 3, h, w)
    total += 2 * res(bi, bi, h, w) + 4 * conv(bi, bi, 1, h, w) + 4 * bi * (h * w) ** 2
    cin, hh, ww = bi, h, w
    for i in reversed(range(len(mult))):
        cout = ch * mult[i]
        for _ in range(nres + 1):
            total += res(cin, cout, hh, ww)
            cin = cout
        if i != 0:
            hh, ww = hh * 2, ww * 2
            total += conv(cout, cout, 3, hh, ww)
    return total + conv(cin, vae["out_ch"], 3, hh, ww)


def llm_shape(llm: dict):
    """(heads, KV heads, head dim, layers)."""
    h = llm["num_attention_heads"]
    return h, llm["num_key_value_heads"], llm["hidden_size"] // h, llm["num_hidden_layers"]


# -- text-to-image -----------------------------------------------------------


def t2i_steps(p: dict):
    """(steps with the three CFG branches, steps with the cond branch
    alone) of the traffic's schedule (the shifted linspace, as the engine
    makes it, in float32)."""
    import numpy as np

    n, s = p["num_timesteps"], p["timestep_shift"]
    f32 = np.float32
    i = np.arange(n - 1, dtype=f32)
    t = np.append(f32(1.0) - i * (f32(1.0) / f32(n - 1)), f32(0.0))
    ts = (f32(s) * t / (f32(1.0) + f32(s - 1.0) * t))[:-1]
    lo, hi = p["cfg_interval"]
    on = int(((ts > lo) & (ts <= hi)).sum())
    return on, len(ts) - on


def t2i_latents(model: dict, px: int) -> int:
    down = 2 ** (len(model["vae"]["ch_mult"]) - 1) * model["latent_patch_size"]
    return (px // down) ** 2


def t2i_b1_calls(model: dict, p: dict, prompt_tokens: int) -> list:
    """Each B1 call (T > 1) one image makes a layer, as (past, valid, t,
    causal): the prompt's prefill into the cond and the cfg_img contexts,
    then every denoise forward's gen block [start, end, latents] over its
    branches' contexts (cond and cfg_img hold the prompt, cfg_text
    nothing)."""
    lp = prompt_tokens + 2  # bos, text, eos
    tb = 2 + t2i_latents(model, p["px"])
    on, off = t2i_steps(p)
    calls = [([0], [lp], lp, True)] * 2
    calls += [([lp, 0, lp], [tb] * 3, tb, False)] * on
    calls += [([lp], [tb], tb, False)] * off
    return calls


def t2i_b1_work(model: dict, p: dict, prompt_tokens: int):
    """(FLOPs, bytes) of one image's B1 calls over every layer."""
    h, kh, d, L = llm_shape(model["llm"])
    f = b = 0
    for past, valid, t, causal in t2i_b1_calls(model, p, prompt_tokens):
        ff, bb = attention_work(past, valid, t, h, kh, d, causal)
        f, b = f + ff, b + bb
    return f * L, b * L


def t2i_image_flops(model: dict, p: dict, prompt_tokens: int) -> int:
    """Model FLOPs of one image: the two prompt prefills, every denoise
    forward (decoder, attention, the latent adapters and the timestep
    embedding a latent), and the VAE decode."""
    llm = model["llm"]
    hid = llm["hidden_size"]
    pd = model["latent_patch_size"] ** 2 * model["vae"]["z_channels"]
    n = t2i_latents(model, p["px"])
    adapters = 2 * n * (pd * hid + 256 * hid + hid * hid + hid * pd)
    total = 0
    for past, valid, t, causal in t2i_b1_calls(model, p, prompt_tokens):
        for pa, v in zip(past, valid):
            pairs = v * pa + (v * (v + 1) // 2 if causal else v * v)
            total += forward_flops(llm, v, pairs) + (0 if causal else adapters)
    side = int(round(n ** 0.5)) * model["latent_patch_size"]
    return total + vae_decode_flops(model["vae"], side, side)


# -- chat ----------------------------------------------------------------------


def chat_prefill(model: dict, prompt_tokens: int, image) -> tuple:
    """(image block tokens, text tokens) a chat request writes: the image
    (its (h, w) in pixels, or None) as [start, end, one token a patch], the
    text as bos, prompt, eos."""
    patch = model["vit"]["patch_size"]
    n_img = 0 if image is None else (image[0] // patch) * (image[1] // patch) + 2
    return n_img, prompt_tokens + 2


def chat_prefill_flops(model: dict, prompt_tokens: int, image) -> int:
    llm, vit = model["llm"], model["vit"]
    n_img, n_txt = chat_prefill(model, prompt_tokens, image)
    total = forward_flops(llm, n_txt, n_txt * n_img + n_txt * (n_txt + 1) // 2)
    if n_img:
        n = n_img - 2
        hid = llm["hidden_size"]
        total += siglip_flops(vit, n) + 2 * n * (vit["hidden_size"] * hid + hid * hid)
        total += forward_flops(llm, n_img, n_img * n_img)
    return total


def chat_prefill_b1_work(model: dict, prompt_tokens: int, image):
    """(FLOPs, bytes) of a request's B1 calls (T > 1) over every layer."""
    h, kh, d, L = llm_shape(model["llm"])
    n_img, n_txt = chat_prefill(model, prompt_tokens, image)
    f, b = attention_work([n_img], [n_txt], n_txt, h, kh, d, True)
    if n_img:
        fi, bi = attention_work([0], [n_img], n_img, h, kh, d, False)
        f, b = f + fi, b + bi
    return f * L, b * L


def decode_token_work(model: dict, past: int):
    """(FLOPs, bytes) of B1's decode pair for one token over `past` cached
    keys, every layer."""
    h, kh, d, L = llm_shape(model["llm"])
    f, b = attention_work([past], [1], 1, h, kh, d, True)
    return f * L, b * L


def decode_token_flops(model: dict, past: int) -> int:
    llm = model["llm"]
    return forward_flops(llm, 1, past + 1, head=llm["vocab_size"])
