"""Interleaved inference engine (port of bagel_tpu/inference/engine.py).

The paths of the JAX engine:
- understanding: an image goes through SigLIP into a non-causal ViT block
  [start, end, vit tokens..., pad] of the context's KV cache, the question
  through a causal text prefill, and `gen_text` decodes the answer;
- text-to-image: text prefill into per-context KV caches, the batched-CFG
  rectified-flow denoise loop split into a CFG-on and a CFG-off phase, and
  the VAE decode; `enable_taylorseer` replaces the LLM forward of most
  steps by a Taylor extrapolation of each branch's velocity
  (inference/taylorseer.py);
- editing: an image in a generation context first takes the VAE pathway
  (vae_encode, then a non-causal block [start, end, clean latents...] at
  t = 0 through the gen expert), then the ViT pathway, then the text, and
  the denoise runs over that context;
- `generate_batch`: several text-to-image requests, each with its own
  prefill, in one denoise whose every forward carries all their branches;
- `chat_batch`: several understanding requests (none, one or several
  images a row) in one batched prefill and one batched decode, over a cache
  of `kv_dtype` (int8 with `kv_quant=True`).
`think=True` decodes a reasoning text first on either path, and
`speculative=K` makes greedy text decodes prompt-lookup speculative
(inference/speculative.py). The loops that
JAX runs under `lax.scan` / `lax.cond` are Python loops here; its text
decode (`_decode_jit`'s `lax.while_loop`) runs as captured chunks of steps
through the engine's `DecodeProgram` (inference/decode_program.py).

Contexts share cache buffers on `copy()` exactly as JAX arrays are shared:
`qwen2.llm_extend` never writes into the cache it is given, and
`decode_text` writes only into the program's own copy, so updating one
context cannot touch a sibling's buffer. A cache that one call owns
(`chat_batch`'s, the serving runtime's slot cache) is written in place
instead (`_extend`, `decode_text(in_place=True)`), where JAX donates it.

Sharded inference (`layout=`, a `parallel.mesh.InferenceLayout` over a
(dp, fsdp, tp) mesh of processes; JAX's `app.py --mesh` with GSPMD): each
process holds its shards of the weights and its KV heads of every cache;
the LLM runs Megatron tp with its fsdp shards gathered a layer at a time
(`qwen2.llm_extend`), the ViT and the adapters (`connector`, `time_embed`,
`vae2llm`, `llm2vae`) are gathered at use and computed replicated, the VAE
is replicated. Every process of the mesh runs every call (dp
coordinates compute the same rows), and all of them see the same outputs
and host reads: an all-reduce leaves the same bits on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from bagel_tpu_torch.configs import BagelConfig
from bagel_tpu_torch.inference.decode_program import DecodeProgram
from bagel_tpu_torch.inference.speculative import decode_text_spec
from bagel_tpu_torch.inference.taylorseer import (
    taylor_eval,
    taylor_update,
    taylorseer_schedule,
)
from bagel_tpu_torch.models import qwen2
from bagel_tpu_torch.models.bagel import (
    cfg_combine,
    encode_vit_tokens,
    latent_to_llm,
    patchify_latent,
    shifted_timesteps,
    unpatchify_latent,
)
from bagel_tpu_torch.models.qwen2 import KVCache, kv_cache_init
from bagel_tpu_torch.models.vae import vae_decode, vae_encode
from bagel_tpu_torch.ops.embeds import (
    flattened_position_ids_extrapolate,
    flattened_position_ids_interpolate,
)
from bagel_tpu_torch.ops.flash import kv_bucket
from bagel_tpu_torch.utils import trace
from bagel_tpu_torch.utils.device import resolve_device
from bagel_tpu_torch.utils.quant import w8a8_kmajor


VLM_THINK_SYSTEM_PROMPT = (
    "You should first think about the reasoning process in the mind and "
    "then provide the user with the answer. \n"
    "The reasoning process is enclosed within <think> </think> tags, i.e. "
    "<think> reasoning process here </think> answer here"
)

GEN_THINK_SYSTEM_PROMPT = (
    "You should first think about the planning process in the mind and "
    "then generate the image. \n"
    "The planning process is enclosed within <think> </think> tags, i.e. "
    "<think> planning process here </think> image here"
)

PREFILL_BUCKET = 32


def _bucket(n: int, step: int = PREFILL_BUCKET) -> int:
    """Pad a length up to a multiple of `step` (default PREFILL_BUCKET). The
    kernel takes any block length; the bucket keeps the prefill shapes of
    the JAX engine on the CPU."""
    return max(step, -(-n // step) * step)


@dataclasses.dataclass
class GenContext:
    """One conversation context: its KV cache, two host-side integers and
    the token history of every text block consumed so far (image blocks add
    no ids)."""

    cache: KVCache
    kv_len: int = 0
    rope: int = 0
    text_ids: tuple = ()

    def copy(self) -> "GenContext":
        # shares the buffers: llm_extend writes out of place
        return GenContext(cache=self.cache, kv_len=self.kv_len, rope=self.rope,
                          text_ids=self.text_ids)


def _whole(params, layout, *names):
    """`params` with the subtrees `names` whole: under a layout their shards
    gathered at use (the ViT and the adapters run replicated)."""
    if layout is None:
        return params
    return dict(params, **{k: layout.gather_tree(params[k], k) for k in names})


def _prefill_text(params, cfg: BagelConfig, cache, ids, pos, valid,
                  attn_impl: str = "auto", layout=None):
    embeds = qwen2.embed_tokens(params["llm"], ids, layout)
    return qwen2.llm_extend(
        params["llm"], cfg.llm, embeds, pos, cache, valid,
        und_len=ids.shape[1], causal=True, update_cache=True, attn_impl=attn_impl,
        layout=layout,
    )


def _extend(params, cfg: BagelConfig, cache, embeds, pos, valid, *, causal: bool,
            attn_impl: str = "auto", layout=None):
    """A batched und-expert block over rows of a cache the caller owns
    (ragged rows through per-row `valid`): written in place, as JAX's
    `_extend_jit` donates the cache. Never call it with a cache that another
    context shares."""
    return qwen2.llm_extend(
        params["llm"], cfg.llm, embeds, pos, cache, valid, und_len=embeds.shape[1],
        causal=causal, update_cache=True, attn_impl=attn_impl, in_place=True, layout=layout,
    )


def _prefill_vit(params, cfg: BagelConfig, cache, boundary_ids, patches,
                 vit_pos, seg, rope_pos: int, valid, attn_impl: str = "auto", layout=None):
    """Understanding-image block [start, end, vit tokens..., pad]: one rope
    position for the whole block, und expert, non-causal."""
    vit_emb = encode_vit_tokens(_whole(params, layout, "vit", "connector"), cfg, patches,
                                vit_pos, seg, attn_impl=attn_impl)
    tok_emb = qwen2.embed_tokens(params["llm"], boundary_ids, layout)  # [2, d]
    block = torch.cat([tok_emb, vit_emb.to(tok_emb.dtype)])[None]
    t = block.shape[1]
    pos = torch.full((1, t), rope_pos, dtype=torch.int32, device=block.device)
    return qwen2.llm_extend(
        params["llm"], cfg.llm, block, pos, cache, valid,
        und_len=t, causal=False, update_cache=True, attn_impl=attn_impl, layout=layout,
    )


def _prefill_vae(params, cfg: BagelConfig, cache, boundary_ids, latents, lat_pos,
                 rope_pos: int, valid, attn_impl: str = "auto", layout=None):
    """Generation-context image block [start, end, clean latents...] at
    t = 0 (upstream bagel.py:491-550): one rope position for the whole
    block, non-causal; the two boundary tokens take the und expert, the
    latents the gen expert (und_len=2)."""
    n = latents.shape[0]
    t_vec = torch.zeros((n,), dtype=torch.float32, device=latents.device)
    lat_emb = latent_to_llm(_whole(params, layout, "vae2llm", "time_embed"), cfg, latents,
                            t_vec, lat_pos)
    tok_emb = qwen2.embed_tokens(params["llm"], boundary_ids, layout)  # [2, d]
    block = torch.cat([tok_emb, lat_emb.to(tok_emb.dtype)])[None]
    t = block.shape[1]
    pos = torch.full((1, t), rope_pos, dtype=torch.int32, device=block.device)
    return qwen2.llm_extend(
        params["llm"], cfg.llm, block, pos, cache, valid,
        und_len=2, causal=False, update_cache=True, attn_impl=attn_impl, layout=layout,
    )


def _make_flow_v(params, cfg: BagelConfig, n: int, n_jobs: int, nb: int,
                 boundary_ids, branch_rope, cache: KVCache, lat_pos,
                 attn_impl: str = "auto", layout=None):
    """Closure computing per-branch velocities for one step.

    x_t is [J, N, pd]; each job expands into its nb CFG branches
    (jobs-major, branch-minor: cache batch = J*nb), every branch of a job
    sharing its latent block [start, end, latents...]; returns
    [J*nb, N, pd] in fp32. Under a layout the adapters are gathered once,
    for every step of the phase."""
    b = n_jobs * nb
    tb = n + 2
    tok_emb = qwen2.embed_tokens(params["llm"], boundary_ids, layout)  # [2, d]
    pos = branch_rope[:, None].expand(b, tb)
    valid = torch.full((b,), tb, dtype=torch.int32, device=tok_emb.device)
    adapters = _whole(params, layout, "vae2llm", "time_embed", "llm2vae")
    head = adapters["llm2vae"]

    def flow_v(x_t, t):
        t_vec = torch.full((n,), float(t), dtype=torch.float32, device=x_t.device)
        lat_emb = latent_to_llm(adapters, cfg, x_t, t_vec, lat_pos)  # [J, N, d]
        d = lat_emb.shape[-1]
        block = torch.cat(
            [tok_emb[None].expand(n_jobs, 2, d), lat_emb.to(tok_emb.dtype)], dim=1
        )
        if nb > 1:  # job j's block at rows [j*nb, (j+1)*nb)
            block = block.repeat_interleave(nb, dim=0)
        hidden, _ = qwen2.llm_extend(
            params["llm"], cfg.llm, block, pos, cache, valid,
            und_len=2, causal=False, update_cache=False, attn_impl=attn_impl, layout=layout,
        )
        # fp32 result of the working-dtype product (upcast inputs)
        return torch.matmul(hidden[:, 2:tb].float(), head["w"].float()) + head["b"].float()

    return flow_v


def _combine(v, n_jobs, nb, cfg_text_scale, cfg_img_scale, cfg_renorm_type,
             cfg_renorm_min):
    """Per-job CFG combination: [J*nb, N, pd] -> [J, N, pd]. Each job's
    branches are in role order, cond, then cfg_text, then cfg_img
    (`gen_image_batch` runs a cfg_img branch only beside a cfg_text one)."""
    v = v.reshape((n_jobs, nb) + v.shape[1:])
    return torch.stack([
        cfg_combine(
            vj[0],
            vj[1] if nb >= 2 else None,
            vj[2] if nb >= 3 else None,
            cfg_text_scale, cfg_img_scale, cfg_renorm_type, cfg_renorm_min,
        )
        for vj in v
    ])


def _denoise_phase(
    params,
    cfg: BagelConfig,
    x_t,  # [J, N, pd]
    k_buf, v_buf, lengths,  # stacked caches [L, J*nb, S, KH, D], [J*nb]
    branch_rope,  # [J*nb] rope position per branch (jobs-major)
    lat_pos,  # [N]
    boundary_ids,  # [2]
    timesteps,  # [K] float32 (host)
    dts,  # [K] float32 (host)
    n_jobs: int,
    n_branches: int,
    cfg_text_scale: float,
    cfg_img_scale: float,
    cfg_renorm_type: str,
    cfg_renorm_min: float,
    attn_impl: str = "auto",
    layout=None,
):
    """K denoise steps: n_jobs images x n_branches CFG forwards batched."""
    n = x_t.shape[1]
    cache = KVCache(k=k_buf, v=v_buf, length=lengths)
    flow_v = _make_flow_v(params, cfg, n, n_jobs, n_branches, boundary_ids,
                          branch_rope, cache, lat_pos, attn_impl, layout)
    for t, dt in zip(timesteps, dts):
        with trace.span("engine.denoise_step", x_t.device, rows=n_jobs * n_branches):
            v = flow_v(x_t, t)
            v_t = _combine(v, n_jobs, n_branches, cfg_text_scale, cfg_img_scale,
                           cfg_renorm_type, cfg_renorm_min)
            x_t = x_t - v_t * float(dt)
    return x_t


TAYLORSEER_MAX_ORDER = 2


def _denoise_phase_taylorseer(
    params,
    cfg: BagelConfig,
    x_t,  # [J, N, pd]
    k_buf, v_buf, lengths,
    branch_rope,
    lat_pos,
    boundary_ids,
    timesteps,  # [K] float32 (host)
    dts,  # [K] float32 (host)
    schedule,  # TaylorSchedule, sliced to these K steps
    factors,  # [O+1, J*nb, N, pd] carried Taylor factors
    n_valid,  # [J*nb] each branch's count of valid factors
    n_jobs: int,
    n_branches: int,
    cfg_text_scale: float,
    cfg_img_scale: float,
    cfg_renorm_type: str,
    cfg_renorm_min: float,
    attn_impl: str = "auto",
    layout=None,
):
    """`_denoise_phase` with the TaylorSeer step cache: a full step runs the
    LLM forward and updates the per-branch Taylor factors of the velocity,
    a Taylor step extrapolates the velocity from them and runs no forward.
    The factors enter and leave the phase, so that one schedule spans the
    whole run, as upstream keeps one cache per branch for the whole
    generate_image call (bagel.py:680-689). Returns (x_t, factors,
    n_valid)."""
    n = x_t.shape[1]
    cache = KVCache(k=k_buf, v=v_buf, length=lengths)
    flow_v = _make_flow_v(params, cfg, n, n_jobs, n_branches, boundary_ids,
                          branch_rope, cache, lat_pos, attn_impl, layout)
    for k, (t, dt) in enumerate(zip(timesteps, dts)):
        full = bool(schedule.is_full[k])
        with trace.span("engine.denoise_step", x_t.device, rows=n_jobs * n_branches, full=full):
            if full:
                v = flow_v(x_t, t)
                factors, n_valid = taylor_update(factors, n_valid, v,
                                                 float(schedule.delta[k]),
                                                 bool(schedule.grow[k]))
            else:
                v = taylor_eval(factors, n_valid, float(schedule.x_off[k]))
            v_t = _combine(v, n_jobs, n_branches, cfg_text_scale, cfg_img_scale,
                           cfg_renorm_type, cfg_renorm_min)
            x_t = x_t - v_t * float(dt)
    return x_t, factors, n_valid


def _initial_noise(job: dict, shape, device) -> torch.Tensor:
    """x_1 of one job: its init_noise if given, else a draw from its
    torch.Generator `rng` (default: a generator seeded 0 on `device`)."""
    init_noise = job.get("init_noise")
    if init_noise is not None:
        x = torch.as_tensor(np.asarray(init_noise, np.float32), device=device)
        assert tuple(x.shape) == tuple(shape), (tuple(x.shape), shape)
        return x
    rng = job.get("rng")
    if rng is None:
        rng = torch.Generator(device=device).manual_seed(0)
    return torch.randn(shape, generator=rng, dtype=torch.float32, device=device)


class BagelEngine:
    """User-facing session API: understanding, text-to-image (with
    TaylorSeer step caching if asked), editing and batched text-to-image
    (`generate_batch`).

    Random numbers differ from `bagel_tpu`'s: without `init_noise` a job's
    x_1 is drawn from a `torch.Generator` (`rng`, by default one seeded 0),
    an edit's posterior sample of the VAE latent from another
    (`update_context_image`'s `rng`, by default one seeded 0), and sampled
    decoding draws tokens with `torch.multinomial`, where the JAX engine
    uses `jax.random.normal(PRNGKey(0))` for both draws and
    `jax.random.categorical`. So on the same weights an image made without
    `init_noise`, an edit, or a text sampled rather than decoded greedily,
    differs from `bagel_tpu`'s; with the draws handed over and greedy
    decoding the two agree (the parity tests run that way).

    The CFG branches are assembled by role (cond, cfg_text, cfg_img), and a
    branch whose velocity is never read is not run: without a cfg_text
    branch (no cfg_text context, or cfg_text_scale <= 1) the combination
    is the cond velocity alone, so the cfg_img branch is dropped too. The
    JAX engine runs [cond, cfg_img] there and, with cfg_text_scale > 1,
    combines the image velocity as if it were the text one; the port gives
    the cond velocity (README, the port's section)."""

    def __init__(
        self,
        params,
        cfg: BagelConfig,
        tokenizer,
        new_token_ids: dict,
        max_kv: int = 8192,
        vae_transform=None,
        vit_transform=None,
        device=None,
        attn_impl: str = "auto",
        kv_quant: bool = False,
        layout=None,
    ):
        """`device`: where the engine runs; CUDA unless the caller passes
        one (the params must already be there).

        Text decodes (`gen_text`, `chat_batch`) run through `self.decode`, a
        `DecodeProgram` (16 steps a CUDA graph).

        `kv_quant=True` stores the understanding-path KV caches (`chat_batch`
        and the serving runtime's slot cache, `kv_dtype`) as int8 codes with
        per-(token, head) f32 scales: half the cache's bytes. Generation
        contexts (`init_context`: text-to-image, edit, `__call__`) stay in
        `cache_dtype`, as in the JAX engine. `attn_impl` goes to every
        attention: "auto" runs the kernels on CUDA and the plain versions on
        the CPU; "dense" takes the plain masked attention everywhere. The
        option is the reference switch: `chip_smoke.py` holds the kernel
        path against a "dense" engine on the card; users leave it at
        "auto".

        `vae_transform` (e.g. `data.transforms.ImageTransform(1024, 512,
        16)`) is applied to every image input of `interleave_inference`;
        `vit_transform` is stored and, as in the JAX engine, not read.

        On CUDA every w8a8 weight of `params` is made k-major in place
        (`utils.quant.w8a8_kmajor`, a no-op where it already is), the layout
        the w8a8 kernel reads.

        `layout` (`parallel.mesh.InferenceLayout`): `params` hold this
        process's shards (`layout.place_tree`, or `utils.bridge.
        params_from_numpy(..., layout=)`); `mesh` is its mesh (None
        without one), as JAX's app sets `engine.mesh`."""
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the card current at construction, not each calling thread's
            # (a new thread's current card is the first one)
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.attn_impl = attn_impl
        self.layout = layout
        self.mesh = None if layout is None else layout.mesh
        emb = params["llm"]["embed"]
        # a quantized embedding ({'w_q', 'row_scale'}, utils.quant) gives
        # bf16 rows, so the engine computes in bf16, as the JAX engine does
        quantized = isinstance(emb, dict)
        emb_dev = emb["w_q"].device if quantized else emb.device
        if emb_dev.type != self.device.type:
            raise ValueError(
                f"params are on {emb_dev}, the engine runs on {self.device}"
            )
        if self.device.type == "cuda":
            w8a8_kmajor(params["llm"])
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.new_token_ids = new_token_ids
        self.max_kv = kv_bucket(max_kv)
        self.vae_transform = vae_transform
        self.vit_transform = vit_transform
        self.decode = DecodeProgram()
        self.cache_dtype = torch.bfloat16 if quantized else emb.dtype
        self.kv_dtype = torch.int8 if kv_quant else self.cache_dtype
        if cfg.interpolate_pos:
            self._pos_ids = flattened_position_ids_interpolate
        else:
            self._pos_ids = flattened_position_ids_extrapolate

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _patches(self, patches: np.ndarray) -> torch.Tensor:
        """Pixel patches rounded to the cache dtype, in the tower's dtype: a
        quantized LLM computes in bf16 beside an f32 tower, whose products
        JAX promotes to f32."""
        tower = self.params["vit"]["patch_embed"]["w"].dtype
        return self._tensor(patches, self.cache_dtype).to(tower)

    # -- context management -------------------------------------------------

    def init_context(self) -> GenContext:
        return GenContext(cache=kv_cache_init(
            self.cfg.llm, 1, self.max_kv, self.cache_dtype, device=self.device,
            layout=self.layout,
        ))

    def _boundary_ids(self) -> torch.Tensor:
        return self._tensor([self.new_token_ids["start_of_image"],
                             self.new_token_ids["end_of_image"]])

    def update_context_text(self, text: str, ctx: GenContext) -> GenContext:
        ids = self._prompt_ids(text)
        t = len(ids)
        tb = _bucket(t)
        ids_arr = np.zeros((1, tb), np.int32)
        ids_arr[0, :t] = ids
        pos = np.zeros((1, tb), np.int32)
        pos[0, :t] = np.arange(ctx.rope, ctx.rope + t)
        _, cache = _prefill_text(
            self.params, self.cfg, ctx.cache, self._tensor(ids_arr, torch.long),
            self._tensor(pos), self._tensor([t]), self.attn_impl, self.layout,
        )
        return GenContext(cache=cache, kv_len=ctx.kv_len + t, rope=ctx.rope + t,
                          text_ids=ctx.text_ids + tuple(ids))

    def _prompt_ids(self, text: str) -> List[int]:
        """A text block's ids: bos, the text, eos."""
        return ([self.new_token_ids["bos_token_id"]] + self.tokenizer.encode(text)
                + [self.new_token_ids["eos_token_id"]])

    def _prep_image_tokens(self, image: np.ndarray, patch: int, max_side: int):
        """image HWC [-1,1] -> (patches [n, p*p*3], pos_ids [n], h, w)."""
        h, w = image.shape[0] // patch, image.shape[1] // patch
        x = image.reshape(h, patch, w, patch, 3).transpose(0, 2, 1, 3, 4)
        patches = x.reshape(h * w, patch * patch * 3)
        pos = np.asarray(self._pos_ids(image.shape[0], image.shape[1], patch, max_side))
        return patches, pos, h, w

    @staticmethod
    def _crop_to_multiple(image: np.ndarray, stride: int) -> np.ndarray:
        """Center-crop H/W down to multiples of `stride` (each pathway crops
        to its own stride instead of resampling)."""
        h = image.shape[0] // stride * stride
        w = image.shape[1] // stride * stride
        oh = (image.shape[0] - h) // 2
        ow = (image.shape[1] - w) // 2
        return image[oh : oh + h, ow : ow + w]

    def update_context_image(
        self, image: np.ndarray, ctx: GenContext, vae: bool = True,
        vit: bool = True, rng: Optional[torch.Generator] = None,
    ) -> GenContext:
        """image: HWC float array in [-1, 1]; each pathway center-crops it
        to its own stride. Each pathway appends one non-causal block and
        advances the context's rope by 1 (one position for the whole image)
        and its kv_len by the block's n + 2 real tokens. First the VAE
        pathway (an edit's generation context): vae_encode with a posterior
        sample from `rng` (default: a generator seeded 0 on the engine's
        device), then [start, end, latents...] at t = 0 through the gen
        expert, n + 2 rows exactly. Then the ViT pathway: [start, end, vit
        tokens..., pad] through the und expert, padded so that it fills a
        prefill bucket."""
        if not (vae or vit):
            raise ValueError("update_context_image needs the vae or the vit pathway")
        cfg = self.cfg
        boundary = self._boundary_ids()
        if vae:
            down = cfg.latent_downsample
            crop = self._crop_to_multiple(image, down)
            if rng is None:
                rng = torch.Generator(device=self.device).manual_seed(0)
            z = vae_encode(self.params["vae"], cfg.vae,
                           self._tensor(crop, torch.float32)[None], generator=rng)[0]
            lat = patchify_latent(z, cfg.latent_patch_size)
            n = lat.shape[0]
            lat_pos = self._pos_ids(crop.shape[0], crop.shape[1], down, cfg.max_latent_size)
            _, cache = _prefill_vae(
                self.params, cfg, ctx.cache, boundary, lat,
                self._tensor(lat_pos, torch.long), ctx.rope, self._tensor([n + 2]),
                self.attn_impl, self.layout,
            )
            ctx = GenContext(cache=cache, kv_len=ctx.kv_len + n + 2, rope=ctx.rope + 1,
                             text_ids=ctx.text_ids)
        if vit:
            patch = cfg.vit.patch_size
            crop = self._crop_to_multiple(image, patch)
            patches, pos, h, w = self._prep_image_tokens(
                crop, patch, cfg.vit_max_num_patch_per_side
            )
            self._check_vit_grid(pos, h, w)
            n = patches.shape[0]
            nb = _bucket(n + 2) - 2  # the block [start, end, tokens...] fills a bucket
            patches_p = np.zeros((nb, patches.shape[1]), np.float32)
            patches_p[:n] = patches
            pos_p = np.zeros(nb, np.int32)
            pos_p[:n] = pos
            seg = np.zeros(nb, np.int32)
            seg[:n] = 1
            _, cache = _prefill_vit(
                self.params, cfg, ctx.cache, boundary,
                self._patches(patches_p), self._tensor(pos_p, torch.long),
                self._tensor(seg), ctx.rope, self._tensor([n + 2]), self.attn_impl,
                self.layout,
            )
            ctx = GenContext(cache=cache, kv_len=ctx.kv_len + n + 2, rope=ctx.rope + 1,
                             text_ids=ctx.text_ids)
        return ctx

    def _check_vit_grid(self, pos: np.ndarray, h: int, w: int) -> None:
        """A patch grid wider than the ViT position tables raises here, where
        JAX's gather clamps the ids to the last row and PyTorch's indexing
        would raise a bare index error."""
        side = self.cfg.vit_max_num_patch_per_side
        patch = self.cfg.vit.patch_size
        rows = min(self.cfg.vit.num_patches_per_side, side) ** 2
        if pos.size and int(pos.max()) >= rows:
            fits = (rows - 1) // (side + 1) + 1  # the widest square grid whose ids fit
            raise ValueError(
                f"the image is a {h} x {w} grid of {patch} px patches; its position ids "
                f"(row x vit_max_num_patch_per_side + column, vit_max_num_patch_per_side "
                f"= {side}) reach {int(pos.max())}, past the ViT position tables' {rows} "
                f"rows: the ViT pathway takes at most a {fits} x {fits} grid, an image of "
                f"{fits * patch} px a side"
            )

    # -- generation ---------------------------------------------------------

    def gen_text(
        self, ctx: GenContext, max_length: int = 500, do_sample: bool = False,
        temperature: float = 1.0, rng: Optional[torch.Generator] = None,
        speculative: int = 0, ngram: int = 3, graph: bool = True,
    ) -> str:
        """Decode from the context, starting with a bos token at its rope
        position: greedy, or sampled from `rng` (default: a generator seeded
        0 on the engine's device). The context is left as it was. The text
        stops before the first eos.

        speculative=K (greedy only): prompt-lookup speculative decode, K
        drafts verified a forward (`inference.speculative`), the same
        tokens; it needs K + 1 entries of KV room past a plain decode's.

        The decode runs through the engine's `DecodeProgram` (`self.decode`):
        on CUDA one graph replay a chunk, over the program's own copy of the
        context's cache; graph=False runs the same steps eagerly (to compare
        against)."""
        eos = self.new_token_ids["eos_token_id"]
        start = self._tensor([self.new_token_ids["bos_token_id"]], torch.long)
        pos = self._tensor([ctx.rope])
        if speculative > 0 and not do_sample:
            if ctx.kv_len + max_length + speculative + 1 > self.max_kv:
                raise ValueError(
                    f"speculative decode needs draft_len + 1 entries of KV room: kv_len "
                    f"{ctx.kv_len} + max_length {max_length} + {speculative + 1} > max_kv "
                    f"{self.max_kv}"
                )
            hist = list(ctx.text_ids)
            harr = np.zeros((1, _bucket(max(len(hist), 1))), np.int64)
            harr[0, : len(hist)] = hist
            toks, _ = decode_text_spec(
                self.params["llm"], self.cfg.llm, ctx.cache, start, pos,
                self._tensor(harr, torch.long), self._tensor([len(hist)], torch.long),
                max_steps=max_length, eos_id=eos, draft_len=speculative, ngram=ngram,
                attn_impl=self.attn_impl, program=self.decode, graph=graph, layout=self.layout,
            )
        else:
            if rng is None:
                rng = torch.Generator(device=self.device).manual_seed(0)
            toks, _ = qwen2.decode_text(
                self.params["llm"], self.cfg.llm, ctx.cache, start, pos,
                max_steps=max_length, eos_id=eos, temperature=temperature,
                do_sample=do_sample, generator=rng, attn_impl=self.attn_impl,
                program=self.decode, graph=graph, layout=self.layout,
            )
        toks = toks[0].tolist()
        if eos in toks:
            toks = toks[: toks.index(eos)]
        return self.tokenizer.decode(toks)

    def gen_image(
        self,
        image_shape: Tuple[int, int],
        ctx: GenContext,
        cfg_text_precontext: Optional[GenContext] = None,
        cfg_img_precontext: Optional[GenContext] = None,
        cfg_text_scale: float = 4.0,
        cfg_img_scale: float = 1.5,
        cfg_interval: Tuple[float, float] = (0.4, 1.0),
        cfg_renorm_min: float = 0.0,
        cfg_renorm_type: str = "global",
        num_timesteps: int = 50,
        timestep_shift: float = 3.0,
        enable_taylorseer: bool = False,
        taylorseer_threshold: int = 3,
        taylorseer_first_enhance: int = 5,
        rng: Optional[torch.Generator] = None,
        init_noise: Optional[np.ndarray] = None,
        return_latent: bool = False,
    ):
        """Rectified-flow generation over the context (text-to-image, or an
        edit when the context holds an image). Returns an HWC uint8 image,
        or with return_latent=True the final packed latent x_0 [h*w, pd]
        (numpy). init_noise [h*w, pd] overrides the draw of x_1 from `rng`.
        taylorseer_threshold / taylorseer_first_enhance: the step cache's
        schedule (upstream defaults 3 / 5, cache_utils/taylorseer.py:79-114):
        full steps 0 .. first_enhance - 1, then every threshold-th."""
        return self.gen_image_batch(
            image_shape,
            [dict(ctx=ctx, cfg_text_precontext=cfg_text_precontext,
                  cfg_img_precontext=cfg_img_precontext, rng=rng,
                  init_noise=init_noise)],
            cfg_text_scale=cfg_text_scale, cfg_img_scale=cfg_img_scale,
            cfg_interval=cfg_interval, cfg_renorm_min=cfg_renorm_min,
            cfg_renorm_type=cfg_renorm_type, num_timesteps=num_timesteps,
            timestep_shift=timestep_shift,
            enable_taylorseer=enable_taylorseer,
            taylorseer_threshold=taylorseer_threshold,
            taylorseer_first_enhance=taylorseer_first_enhance,
            return_latent=return_latent,
        )[0]

    def gen_image_batch(
        self,
        image_shape: Tuple[int, int],
        jobs: List[dict],
        cfg_text_scale: float = 4.0,
        cfg_img_scale: float = 1.5,
        cfg_interval: Tuple[float, float] = (0.4, 1.0),
        cfg_renorm_min: float = 0.0,
        cfg_renorm_type: str = "global",
        num_timesteps: int = 50,
        timestep_shift: float = 3.0,
        enable_taylorseer: bool = False,
        taylorseer_threshold: int = 3,
        taylorseer_first_enhance: int = 5,
        return_latent: bool = False,
    ) -> List[np.ndarray]:
        """Denoise J independent images in one batched loop; every LLM
        forward carries all jobs' CFG branches.

        Each job is a dict with keys ctx (required), cfg_text_precontext,
        cfg_img_precontext, rng, init_noise. All jobs share image_shape,
        the CFG scales and schedule, and their branch structure."""
        cfg = self.cfg
        H, W = image_shape
        down = cfg.latent_downsample
        h, w = H // down, W // down
        n = h * w
        pd = cfg.patch_latent_dim
        J = len(jobs)
        assert J >= 1

        x_t = torch.stack([_initial_noise(job, (n, pd), self.device) for job in jobs])
        lat_pos = self._tensor(self._pos_ids(H, W, down, cfg.max_latent_size), torch.long)

        ts, dts = shifted_timesteps(num_timesteps, timestep_shift)
        cfg_on = (ts > cfg_interval[0]) & (ts <= cfg_interval[1])
        tb = n + 2  # the gen block is written at kv_len of every branch

        has_text = [j.get("cfg_text_precontext") is not None for j in jobs]
        has_img = [j.get("cfg_img_precontext") is not None for j in jobs]
        assert all(x == has_text[0] for x in has_text), \
            "non-uniform cfg_text branch structure"
        assert all(x == has_img[0] for x in has_img), \
            "non-uniform cfg_img branch structure"
        # branches by role; cfg_combine reads the cfg_img velocity only
        # beside a cfg_text one
        use_text = cfg_text_scale > 1.0 and has_text[0]
        use_img = use_text and cfg_img_scale > 1.0 and has_img[0]
        branches: List[List[GenContext]] = []  # jobs-major, branch-minor
        conds: List[List[GenContext]] = []
        for job in jobs:
            row = [job["ctx"]]
            if use_text:
                row.append(job["cfg_text_precontext"])
            if use_img:
                row.append(job["cfg_img_precontext"])
            for c in row:
                assert c.kv_len + tb <= self.max_kv, (
                    f"KV buffer too small: kv_len={c.kv_len} + block={tb} > "
                    f"max_kv={self.max_kv}"
                )
            branches.append(row)
            conds.append([job["ctx"]])

        boundary = self._boundary_ids()
        idx_on = np.nonzero(cfg_on)[0]
        idx_off = np.nonzero(~cfg_on)[0]
        if len(idx_on) and len(idx_off):  # the schedule is monotone
            assert idx_on.max() < idx_off.min() or idx_off.max() < idx_on.min()

        if enable_taylorseer:
            # one schedule over the whole run (len(ts) forwards), sliced per
            # phase: upstream's cond branch keeps one cache for all steps
            sch = taylorseer_schedule(len(ts), fresh_threshold=taylorseer_threshold,
                                      first_enhance=taylorseer_first_enhance)
        carry = None  # (factors [O+1, J*nb, n, pd], n_valid [J*nb]) of the last phase

        def run(x_t, idxs, rows, text_s, img_s):
            nonlocal carry
            if len(idxs) == 0:
                return x_t
            ctxs = [c for row in rows for c in row]
            b = len(rows[0])  # branches per job in this phase
            args = (
                self.params, cfg, x_t,
                torch.cat([c.cache.k for c in ctxs], dim=1),
                torch.cat([c.cache.v for c in ctxs], dim=1),
                torch.cat([c.cache.length for c in ctxs]),
                self._tensor([c.rope for c in ctxs]), lat_pos, boundary,
                ts[idxs], dts[idxs],
            )
            common = dict(
                n_jobs=J, n_branches=b, cfg_text_scale=text_s, cfg_img_scale=img_s,
                cfg_renorm_type=cfg_renorm_type, cfg_renorm_min=cfg_renorm_min,
                attn_impl=self.attn_impl, layout=self.layout,
            )
            if not enable_taylorseer:
                return _denoise_phase(*args, **common)
            if carry is None:
                factors = torch.zeros((TAYLORSEER_MAX_ORDER + 1, J * b, n, pd),
                                      dtype=torch.float32, device=self.device)
                n_valid = torch.zeros((J * b,), dtype=torch.int32, device=self.device)
            else:  # re-lay the last phase's factors out for this phase's branches
                f, nv = carry
                bp = f.shape[1] // J
                fj, nvj = f.reshape(f.shape[0], J, bp, n, pd), nv.reshape(J, bp)
                if bp >= b:  # branches dropped; branch 0 is cond
                    fj, nvj = fj[:, :, :b], nvj[:, :b]
                else:  # new branches enter with zero factors and none valid
                    fj = torch.cat([fj, fj.new_zeros((fj.shape[0], J, b - bp, n, pd))], dim=2)
                    nvj = torch.cat([nvj, nvj.new_zeros((J, b - bp))], dim=1)
                factors, n_valid = fj.reshape(fj.shape[0], J * b, n, pd), nvj.reshape(J * b)
            x_t, factors, n_valid = _denoise_phase_taylorseer(
                *args, sch._make(a[idxs] for a in sch), factors, n_valid, **common)
            carry = (factors, n_valid)
            return x_t

        if len(idx_on) and len(idx_off) and idx_on.min() > idx_off.min():
            # the cfg window starts later in the run
            x_t = run(x_t, idx_off[idx_off < idx_on.min()], conds, 1.0, 1.0)
            x_t = run(x_t, idx_on, branches, cfg_text_scale, cfg_img_scale)
            x_t = run(x_t, idx_off[idx_off > idx_on.max()], conds, 1.0, 1.0)
        else:
            x_t = run(x_t, idx_on, branches, cfg_text_scale, cfg_img_scale)
            x_t = run(x_t, idx_off, conds, 1.0, 1.0)

        if return_latent:
            return list(x_t.cpu().numpy())
        z = torch.stack([
            unpatchify_latent(x, h, w, cfg.latent_patch_size, cfg.latent_channel)
            for x in x_t
        ])
        with trace.span("engine.vae_decode", self.device):
            imgs = vae_decode(self.params["vae"], cfg.vae, z)
        imgs = (torch.clamp(imgs * 0.5 + 0.5, 0, 1) * 255).to(torch.uint8)
        return list(imgs.cpu().numpy())

    # -- batched understanding ----------------------------------------------

    def _pack_images(self, row_images: dict):
        """Every image of every row ({row: [images]}) as one packed ViT pass
        (one segment an image): (vit_emb [tokens, d], {(row, k): (offset,
        n)}) for the k-th image of each row, or (None, {}) without images."""
        patch = self.cfg.vit.patch_size
        per_img, all_p, all_pos, all_seg = {}, [], [], []
        off = 0
        for i, imgs in row_images.items():
            for k, im in enumerate(imgs):
                crop = self._crop_to_multiple(im, patch)
                patches, pos, h, w = self._prep_image_tokens(
                    crop, patch, self.cfg.vit_max_num_patch_per_side
                )
                self._check_vit_grid(pos, h, w)
                per_img[(i, k)] = (off, patches.shape[0])
                off += patches.shape[0]
                all_p.append(patches)
                all_pos.append(pos)
                all_seg.append(np.full(patches.shape[0], len(all_seg) + 1, np.int32))
        if not all_p:
            return None, per_img
        flat = np.concatenate(all_p, 0)
        nb = _bucket(flat.shape[0], 64)
        packed = np.zeros((nb, flat.shape[1]), np.float32)
        packed[:off] = flat
        pos_p = np.zeros(nb, np.int64)
        pos_p[:off] = np.concatenate(all_pos, 0)
        seg_p = np.zeros(nb, np.int32)
        seg_p[:off] = np.concatenate(all_seg, 0)
        vit_emb = encode_vit_tokens(
            _whole(self.params, self.layout, "vit", "connector"), self.cfg,
            self._patches(packed), self._tensor(pos_p, torch.long),
            self._tensor(seg_p), attn_impl=self.attn_impl,
        )
        return vit_emb, per_img

    def _image_rounds(self, cache: KVCache, rows: List[int], row_images: dict,
                      vit_emb, per_img: dict, rope: dict) -> KVCache:
        """One batched non-causal extend per image round: round k writes the
        block [start, end, vit tokens...] of the k-th image of every row in
        `rows` that has one (valid = 0 elsewhere), each at its row's rope
        position, which then advances by 1. The cache is written in place;
        `rope` ({row: position}) is updated."""
        b = cache.batch
        tok_emb = qwen2.embed_tokens(self.params["llm"], self._boundary_ids(), self.layout)
        rounds = max((len(row_images[i]) for i in rows), default=0)
        for k in range(rounds):
            rows_k = [i for i in rows if len(row_images[i]) > k]
            tb = _bucket(max(per_img[(i, k)][1] for i in rows_k) + 2)
            blocks = torch.zeros((b, tb, vit_emb.shape[-1]), dtype=tok_emb.dtype,
                                 device=self.device)
            valid = np.zeros(b, np.int32)
            pos = np.zeros((b, tb), np.int32)
            for i in rows_k:
                off, n = per_img[(i, k)]
                blocks[i, :2] = tok_emb
                blocks[i, 2 : n + 2] = vit_emb[off : off + n].to(tok_emb.dtype)
                valid[i] = n + 2
                pos[i] = rope[i]  # one rope position for the whole image
            _, cache = _extend(self.params, self.cfg, cache, blocks, self._tensor(pos),
                               self._tensor(valid), causal=False, attn_impl=self.attn_impl,
                               layout=self.layout)
            for i in rows_k:
                rope[i] += 1
        return cache

    def _text_rows(self, cache: KVCache, ids_rows: dict, rope: dict) -> KVCache:
        """One batched causal extend of each row's text ids ({row: ids}, each
        at its row's rope position; valid = 0 for the other rows), written
        in place."""
        b = cache.batch
        tb = _bucket(max(len(x) for x in ids_rows.values()))
        ids = np.zeros((b, tb), np.int64)
        pos = np.zeros((b, tb), np.int32)
        valid = np.zeros(b, np.int32)
        for i, x in ids_rows.items():
            ids[i, : len(x)] = x
            pos[i, : len(x)] = rope[i] + np.arange(len(x))
            valid[i] = len(x)
        embeds = qwen2.embed_tokens(self.params["llm"], self._tensor(ids, torch.long),
                                    self.layout)
        _, cache = _extend(self.params, self.cfg, cache, embeds, self._tensor(pos),
                           self._tensor(valid), causal=True, attn_impl=self.attn_impl,
                           layout=self.layout)
        return cache

    def chat_batch(
        self,
        images: List[Union[None, np.ndarray, List[np.ndarray]]],
        prompts: List[str],
        max_length: int = 256,
        do_sample: bool = False,
        temperature: float = 1.0,
        rng: Optional[torch.Generator] = None,
        graph: bool = True,
    ) -> List[str]:
        """Answer B (images, prompt) pairs in one batched prefill and one
        batched decode, over a B-row cache of `kv_dtype` that the engine's
        `DecodeProgram` owns (its graphs stay valid from call to call; the
        call holds the program's lock; graph=False as in `gen_text`).

        Each row passes None, one image (HWC float in [-1, 1]) or a list of
        images. All images of all rows go through SigLIP in one packed pass;
        each image is its own non-causal block [start, end, vit tokens...]
        that advances its row's rope by 1, one batched extend per image
        round (rows with fewer images sit the later rounds out). Then the
        prompts as one causal block, then a B-row `decode_text` (greedy, or
        sampled from `rng`)."""
        b = len(prompts)
        if len(images) != b:
            raise ValueError(f"{len(images)} image entries for {b} prompts")
        row_images = {
            i: [] if im is None else ([im] if isinstance(im, np.ndarray) else list(im))
            for i, im in enumerate(images)
        }
        with self.decode.lock:  # its owned cache is one call's from prefill to decode
            cache = self.decode.owned_cache(self.cfg.llm, b, self.max_kv, self.kv_dtype,
                                            self.device, self.layout)
            rope = {i: 0 for i in range(b)}
            vit_emb, per_img = self._pack_images(row_images)
            if vit_emb is not None:
                cache = self._image_rounds(cache, list(range(b)), row_images, vit_emb,
                                           per_img, rope)
            ids_rows = {i: self._prompt_ids(p) for i, p in enumerate(prompts)}
            cache = self._text_rows(cache, ids_rows, rope)
            if rng is None:
                rng = torch.Generator(device=self.device).manual_seed(0)
            eos = self.new_token_ids["eos_token_id"]
            toks, _ = qwen2.decode_text(
                self.params["llm"], self.cfg.llm, cache,
                self._tensor([self.new_token_ids["bos_token_id"]] * b, torch.long),
                self._tensor([rope[i] + len(ids_rows[i]) for i in range(b)]),
                max_steps=max_length, eos_id=eos, temperature=temperature,
                do_sample=do_sample, generator=rng, attn_impl=self.attn_impl, in_place=True,
                program=self.decode, graph=graph, layout=self.layout,
            )
        outs = []
        for row in toks.tolist():
            if eos in row:
                row = row[: row.index(eos)]
            outs.append(self.tokenizer.decode(row))
        return outs

    # -- top-level interleaved API ------------------------------------------

    def interleave_inference(
        self,
        input_list: List[Union[str, np.ndarray]],
        think: bool = False,
        understanding_output: bool = False,
        max_think_token_n: int = 1000,
        do_sample: bool = False,
        text_temperature: float = 0.3,
        cfg_text_scale: float = 3.0,
        cfg_img_scale: float = 1.5,
        cfg_interval: Tuple[float, float] = (0.4, 1.0),
        timestep_shift: float = 3.0,
        num_timesteps: int = 50,
        cfg_renorm_min: float = 0.0,
        cfg_renorm_type: str = "global",
        image_shapes: Tuple[int, int] = (1024, 1024),
        enable_taylorseer: bool = False,
        taylorseer_threshold: int = 3,
        taylorseer_first_enhance: int = 5,
        rng: Optional[torch.Generator] = None,
        speculative: int = 0,
    ) -> List[Union[str, np.ndarray]]:
        """Texts and images in; a decoded answer (understanding_output), or
        an image, preceded by its reasoning text with think=True, out. Image
        inputs (after `vae_transform`, if the engine has one) take the ViT
        pathway when understanding_output is set, and the VAE pathway and
        then the ViT pathway otherwise (an edit: the output image has the
        input's size). `rng` draws x_1; an edit's posterior sample takes
        `update_context_image`'s default generator.

        With understanding_output the CFG contexts are never read, so the
        port does not prefill the cfg_img context there (the JAX engine
        does, and drops it): one text prefill per text input, not two."""
        output: List[Union[str, np.ndarray]] = []
        ctx = self.init_context()
        cfg_text_ctx = ctx.copy()
        cfg_img_ctx = ctx.copy()

        if think:
            sys_prompt = (
                VLM_THINK_SYSTEM_PROMPT if understanding_output
                else GEN_THINK_SYSTEM_PROMPT
            )
            ctx = self.update_context_text(sys_prompt, ctx)
            if not understanding_output:
                cfg_img_ctx = self.update_context_text(sys_prompt, cfg_img_ctx)

        for term in input_list:
            if isinstance(term, str):
                cfg_text_ctx = ctx.copy()
                ctx = self.update_context_text(term, ctx)
                if not understanding_output:
                    cfg_img_ctx = self.update_context_text(term, cfg_img_ctx)
            elif isinstance(term, np.ndarray):
                if self.vae_transform is not None:
                    term = self.vae_transform(term)
                ctx = self.update_context_image(
                    term, ctx, vae=not understanding_output, vit=True
                )
                image_shapes = term.shape[:2]
                cfg_text_ctx = ctx.copy()
            else:
                raise ValueError(f"Unsupported input type: {type(term)}")

        if understanding_output:
            output.append(self.gen_text(
                ctx, max_length=max_think_token_n, do_sample=do_sample,
                temperature=text_temperature, speculative=speculative,
            ))
            return output

        if think:
            txt = self.gen_text(
                ctx, max_length=max_think_token_n, do_sample=do_sample,
                temperature=text_temperature, speculative=speculative,
            )
            ctx = self.update_context_text(txt, ctx)
            output.append(txt)

        output.append(self.gen_image(
            image_shapes, ctx,
            cfg_text_precontext=cfg_text_ctx,
            cfg_img_precontext=cfg_img_ctx,
            cfg_text_scale=cfg_text_scale, cfg_img_scale=cfg_img_scale,
            cfg_interval=cfg_interval, timestep_shift=timestep_shift,
            num_timesteps=num_timesteps, cfg_renorm_min=cfg_renorm_min,
            cfg_renorm_type=cfg_renorm_type,
            enable_taylorseer=enable_taylorseer,
            taylorseer_threshold=taylorseer_threshold,
            taylorseer_first_enhance=taylorseer_first_enhance, rng=rng,
        ))
        return output

    def __call__(self, image=None, text=None, **kwargs):
        """{"image": HWC uint8 or None, "text": str or None}."""
        out = {"image": None, "text": None}
        inputs = [x for x in (image, text) if x is not None]
        if not inputs:
            return out
        for item in self.interleave_inference(inputs, **kwargs):
            if isinstance(item, np.ndarray):
                out["image"] = item
            else:
                out["text"] = item
        return out

    def generate_batch(self, reqs: List[dict]) -> List[dict]:
        """B text-to-image requests through one batched denoise.

        Each request is a `__call__` kwargs dict; all must share one
        `gen_batch_key`. The prefills stay per request (ctx, an empty
        cfg_text context, cfg_img = ctx), and every denoise forward carries
        all the requests' CFG branches (`gen_image_batch`); each request's
        x_1 comes from its own `rng`."""
        keys = {gen_batch_key(kw) for kw in reqs}
        if len(keys) != 1 or None in keys:
            raise ValueError(f"generate_batch needs one shared batchable key, got {keys}")
        kw0 = {k: reqs[0].get(k, d) for k, d in _BATCHABLE_GEN_DEFAULTS.items()}
        jobs = []
        for kw in reqs:
            ctx = self.init_context()
            cfg_text_ctx = ctx.copy()
            ctx = self.update_context_text(kw["text"], ctx)
            jobs.append(dict(ctx=ctx, cfg_text_precontext=cfg_text_ctx,
                             cfg_img_precontext=ctx.copy(), rng=kw.get("rng")))
        imgs = self.gen_image_batch(
            kw0.pop("image_shapes"), jobs, **kw0)
        return [{"image": im, "text": None} for im in imgs]


# interleave_inference's defaults: the batch key sees the same value whether
# a caller passed it or not
_BATCHABLE_GEN_DEFAULTS = dict(
    cfg_text_scale=3.0,
    cfg_img_scale=1.5,
    cfg_interval=(0.4, 1.0),
    timestep_shift=3.0,
    num_timesteps=50,
    cfg_renorm_min=0.0,
    cfg_renorm_type="global",
    image_shapes=(1024, 1024),
    enable_taylorseer=False,
    taylorseer_threshold=3,
    taylorseer_first_enhance=5,
)


def gen_batch_key(kwargs: dict) -> Optional[tuple]:
    """Grouping key for batched text-to-image, or None where a request
    cannot join a batched denoise (an image input, think, understanding,
    or a kwarg that changes a request's control flow)."""
    if kwargs.get("image") is not None:
        return None
    if kwargs.get("think", False) or kwargs.get("understanding_output", False):
        return None
    if not kwargs.get("text"):
        return None
    allowed = {"text", "rng", "think", "understanding_output",
               "speculative", *_BATCHABLE_GEN_DEFAULTS}
    if set(kwargs) - allowed:
        return None
    return tuple(
        (k, repr(kwargs.get(k, d)))
        for k, d in sorted(_BATCHABLE_GEN_DEFAULTS.items())
    )
