"""Text-to-image inference engine (port of bagel_tpu/inference/engine.py).

The text-to-image slice of the JAX engine: text prefill into per-context KV
caches, the batched-CFG rectified-flow denoise loop split into a CFG-on and
a CFG-off phase, and the VAE decode. The loops that JAX runs under
`lax.scan` are Python loops here; PyTorch runs eagerly.

Contexts share cache buffers on `copy()` exactly as JAX arrays are shared:
`qwen2.llm_extend` never writes into the cache it is given, so updating one
context cannot touch a sibling's buffer.

Image inputs, think mode, understanding output and TaylorSeer step caching
raise NotImplementedError naming the slice that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from bagel_tpu_torch.configs import BagelConfig
from bagel_tpu_torch.models import qwen2
from bagel_tpu_torch.models.bagel import (
    cfg_combine,
    latent_to_llm,
    shifted_timesteps,
    unpatchify_latent,
)
from bagel_tpu_torch.models.qwen2 import KVCache, kv_cache_init
from bagel_tpu_torch.models.vae import vae_decode
from bagel_tpu_torch.ops.embeds import (
    flattened_position_ids_extrapolate,
    flattened_position_ids_interpolate,
)
from bagel_tpu_torch.ops.flash import kv_bucket
from bagel_tpu_torch.utils.device import resolve_device


PREFILL_BUCKET = 32


def _bucket(n: int) -> int:
    """Pad a prompt length up to a multiple of PREFILL_BUCKET. The kernel
    takes any block length; the bucket keeps the prefill shapes of the JAX
    engine on the CPU."""
    return max(PREFILL_BUCKET, -(-n // PREFILL_BUCKET) * PREFILL_BUCKET)


@dataclasses.dataclass
class GenContext:
    """One conversation context: its KV cache and two host-side integers."""

    cache: KVCache
    kv_len: int = 0
    rope: int = 0

    def copy(self) -> "GenContext":
        # shares the buffers: llm_extend writes out of place
        return GenContext(cache=self.cache, kv_len=self.kv_len, rope=self.rope)


def _prefill_text(params, cfg: BagelConfig, cache, ids, pos, valid):
    embeds = qwen2.embed_tokens(params["llm"], ids)
    return qwen2.llm_extend(
        params["llm"], cfg.llm, embeds, pos, cache, valid,
        und_len=ids.shape[1], causal=True, update_cache=True,
    )


def _make_flow_v(params, cfg: BagelConfig, n: int, n_jobs: int, nb: int,
                 boundary_ids, branch_rope, cache: KVCache, lat_pos):
    """Closure computing per-branch velocities for one step.

    x_t is [J, N, pd]; each job expands into its nb CFG branches
    (jobs-major, branch-minor: cache batch = J*nb), every branch of a job
    sharing its latent block [start, end, latents...]; returns
    [J*nb, N, pd] in fp32."""
    b = n_jobs * nb
    tb = n + 2
    tok_emb = qwen2.embed_tokens(params["llm"], boundary_ids)  # [2, d]
    pos = branch_rope[:, None].expand(b, tb)
    valid = torch.full((b,), tb, dtype=torch.int32, device=tok_emb.device)
    head = params["llm2vae"]

    def flow_v(x_t, t):
        t_vec = torch.full((n,), float(t), dtype=torch.float32, device=x_t.device)
        lat_emb = latent_to_llm(params, cfg, x_t, t_vec, lat_pos)  # [J, N, d]
        d = lat_emb.shape[-1]
        block = torch.cat(
            [tok_emb[None].expand(n_jobs, 2, d), lat_emb.to(tok_emb.dtype)], dim=1
        )
        if nb > 1:  # job j's block at rows [j*nb, (j+1)*nb)
            block = block.repeat_interleave(nb, dim=0)
        hidden, _ = qwen2.llm_extend(
            params["llm"], cfg.llm, block, pos, cache, valid,
            und_len=2, causal=False, update_cache=False,
        )
        # fp32 result of the working-dtype product (upcast inputs)
        return torch.matmul(hidden[:, 2:tb].float(), head["w"].float()) + head["b"].float()

    return flow_v


def _combine(v, n_jobs, nb, cfg_text_scale, cfg_img_scale, cfg_renorm_type,
             cfg_renorm_min):
    """Per-job CFG combination: [J*nb, N, pd] -> [J, N, pd]."""
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
):
    """K denoise steps: n_jobs images x n_branches CFG forwards batched."""
    n = x_t.shape[1]
    cache = KVCache(k=k_buf, v=v_buf, length=lengths)
    flow_v = _make_flow_v(params, cfg, n, n_jobs, n_branches, boundary_ids,
                          branch_rope, cache, lat_pos)
    for t, dt in zip(timesteps, dts):
        v = flow_v(x_t, t)
        v_t = _combine(v, n_jobs, n_branches, cfg_text_scale, cfg_img_scale,
                       cfg_renorm_type, cfg_renorm_min)
        x_t = x_t - v_t * float(dt)
    return x_t


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
    """User-facing session API, text-to-image slice."""

    def __init__(
        self,
        params,
        cfg: BagelConfig,
        tokenizer,
        new_token_ids: dict,
        max_kv: int = 8192,
        device=None,
    ):
        """`device`: where the engine runs; CUDA unless the caller passes
        one (the params must already be there)."""
        self.device = resolve_device(device)
        emb = params["llm"]["embed"]
        if emb.device.type != self.device.type:
            raise ValueError(
                f"params are on {emb.device}, the engine runs on {self.device}"
            )
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.new_token_ids = new_token_ids
        self.max_kv = kv_bucket(max_kv)
        self.cache_dtype = emb.dtype
        if cfg.interpolate_pos:
            self._pos_ids = flattened_position_ids_interpolate
        else:
            self._pos_ids = flattened_position_ids_extrapolate

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # -- context management -------------------------------------------------

    def init_context(self) -> GenContext:
        return GenContext(cache=kv_cache_init(
            self.cfg.llm, 1, self.max_kv, self.cache_dtype, device=self.device
        ))

    def _boundary_ids(self) -> torch.Tensor:
        return self._tensor([self.new_token_ids["start_of_image"],
                             self.new_token_ids["end_of_image"]])

    def update_context_text(self, text: str, ctx: GenContext) -> GenContext:
        ids = (
            [self.new_token_ids["bos_token_id"]]
            + self.tokenizer.encode(text)
            + [self.new_token_ids["eos_token_id"]]
        )
        t = len(ids)
        tb = _bucket(t)
        ids_arr = np.zeros((1, tb), np.int32)
        ids_arr[0, :t] = ids
        pos = np.zeros((1, tb), np.int32)
        pos[0, :t] = np.arange(ctx.rope, ctx.rope + t)
        _, cache = _prefill_text(
            self.params, self.cfg, ctx.cache, self._tensor(ids_arr, torch.long),
            self._tensor(pos), self._tensor([t]),
        )
        return GenContext(cache=cache, kv_len=ctx.kv_len + t, rope=ctx.rope + t)

    # -- generation ---------------------------------------------------------

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
        rng: Optional[torch.Generator] = None,
        init_noise: Optional[np.ndarray] = None,
        return_latent: bool = False,
    ):
        """Rectified-flow text-to-image. Returns an HWC uint8 image, or with
        return_latent=True the final packed latent x_0 [h*w, pd] (numpy).
        init_noise [h*w, pd] overrides the draw of x_1 from `rng`."""
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
        return_latent: bool = False,
    ) -> List[np.ndarray]:
        """Denoise J independent images in one batched loop; every LLM
        forward carries all jobs' CFG branches.

        Each job is a dict with keys ctx (required), cfg_text_precontext,
        cfg_img_precontext, rng, init_noise. All jobs share image_shape,
        the CFG scales and schedule, and their branch structure."""
        if enable_taylorseer:
            raise NotImplementedError(
                "TaylorSeer step caching comes with the TaylorSeer slice"
            )
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
        use_text = cfg_text_scale > 1.0 and has_text[0]
        use_img = cfg_img_scale > 1.0 and has_img[0]
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

        def run(x_t, idxs, rows, text_s, img_s):
            if len(idxs) == 0:
                return x_t
            ctxs = [c for row in rows for c in row]
            return _denoise_phase(
                self.params, cfg, x_t,
                torch.cat([c.cache.k for c in ctxs], dim=1),
                torch.cat([c.cache.v for c in ctxs], dim=1),
                torch.cat([c.cache.length for c in ctxs]),
                self._tensor([c.rope for c in ctxs]), lat_pos, boundary,
                ts[idxs], dts[idxs],
                n_jobs=J, n_branches=len(rows[0]),
                cfg_text_scale=text_s, cfg_img_scale=img_s,
                cfg_renorm_type=cfg_renorm_type, cfg_renorm_min=cfg_renorm_min,
            )

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
        imgs = vae_decode(self.params["vae"], cfg.vae, z)
        imgs = (torch.clamp(imgs * 0.5 + 0.5, 0, 1) * 255).to(torch.uint8)
        return list(imgs.cpu().numpy())

    # -- top-level interleaved API ------------------------------------------

    def interleave_inference(
        self,
        input_list: List[str],
        think: bool = False,
        understanding_output: bool = False,
        cfg_text_scale: float = 3.0,
        cfg_img_scale: float = 1.5,
        cfg_interval: Tuple[float, float] = (0.4, 1.0),
        timestep_shift: float = 3.0,
        num_timesteps: int = 50,
        cfg_renorm_min: float = 0.0,
        cfg_renorm_type: str = "global",
        image_shapes: Tuple[int, int] = (1024, 1024),
        enable_taylorseer: bool = False,
        rng: Optional[torch.Generator] = None,
    ) -> List[np.ndarray]:
        """Text prompts in, one generated image out (the text-to-image
        branch of the JAX engine's interleave_inference)."""
        if understanding_output:
            raise NotImplementedError(
                "understanding output (text decode) comes with the "
                "understanding slice"
            )
        if think:
            raise NotImplementedError(
                "think mode needs text decode, which comes with the "
                "understanding slice"
            )
        ctx = self.init_context()
        cfg_text_ctx = ctx.copy()
        cfg_img_ctx = ctx.copy()
        for term in input_list:
            if isinstance(term, np.ndarray):
                raise NotImplementedError(
                    "image inputs come with the understanding and edit slices"
                )
            if not isinstance(term, str):
                raise ValueError(f"Unsupported input type: {type(term)}")
            cfg_text_ctx = ctx.copy()
            ctx = self.update_context_text(term, ctx)
            cfg_img_ctx = self.update_context_text(term, cfg_img_ctx)

        img = self.gen_image(
            image_shapes, ctx,
            cfg_text_precontext=cfg_text_ctx,
            cfg_img_precontext=cfg_img_ctx,
            cfg_text_scale=cfg_text_scale, cfg_img_scale=cfg_img_scale,
            cfg_interval=cfg_interval, timestep_shift=timestep_shift,
            num_timesteps=num_timesteps, cfg_renorm_min=cfg_renorm_min,
            cfg_renorm_type=cfg_renorm_type,
            enable_taylorseer=enable_taylorseer, rng=rng,
        )
        return [img]

    def __call__(self, image=None, text=None, **kwargs):
        inputs = [x for x in (image, text) if x is not None]
        if not inputs:
            return {"image": None, "text": None}
        (img,) = self.interleave_inference(inputs, **kwargs)
        return {"image": img, "text": None}
