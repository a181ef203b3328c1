"""Model configuration dataclasses for the PyTorch port.

A copy of `bagel_tpu/configs.py` (the port imports nothing of `bagel_tpu`).
They mirror the upstream BAGEL configs (modeling/bagel/bagel.py:27-54
BagelConfig, qwen2_navit.py:46-204 Qwen2Config, siglip_navit.py:21-99
SiglipVisionConfig, autoencoder.py:20-31 AutoEncoderParams) as plain frozen
dataclasses: pure data, JSON round-trippable, hashable.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Qwen2Config:
    """Decoder-only LLM backbone config (Qwen2.5 family + BAGEL MoT extensions)."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    hidden_act: str = "silu"
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = False
    # BAGEL extensions (qwen2_navit.py:202-204)
    qk_norm: bool = True
    # one of: "dense" (Qwen2DecoderLayer), "moe" (Qwen2MoEDecoderLayer: shared
    # attn, dual FFN), "mot" (Qwen2MoTDecoderLayer: dual attn projections,
    # norms and FFN; attention itself shared)
    layer_module: str = "mot"
    freeze_und: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def use_moe(self) -> bool:
        return self.layer_module in ("moe", "mot")


@dataclass(frozen=True)
class SiglipConfig:
    """SigLIP vision tower config (NaViT packed variant)."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_channels: int = 3
    image_size: int = 980
    patch_size: int = 14
    hidden_act: str = "gelu_pytorch_tanh"
    layer_norm_eps: float = 1e-6
    rope: bool = True  # 2-D rotary over the patch grid (siglip_navit.py:99)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def patch_dim(self) -> int:
        return self.num_channels * self.patch_size**2


@dataclass(frozen=True)
class VAEConfig:
    """FLUX-style conv VAE (autoencoder.py:339-351 fixed params)."""

    resolution: int = 256
    in_channels: int = 3
    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 16
    scale_factor: float = 0.3611
    shift_factor: float = 0.1159

    @property
    def downsample(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


@dataclass(frozen=True)
class BagelConfig:
    """Top-level unified-model config (bagel.py:27-54)."""

    visual_gen: bool = True
    visual_und: bool = True
    llm: Qwen2Config = dataclasses.field(default_factory=Qwen2Config)
    vit: Optional[SiglipConfig] = dataclasses.field(default_factory=SiglipConfig)
    vae: Optional[VAEConfig] = dataclasses.field(default_factory=VAEConfig)
    latent_patch_size: int = 2
    max_latent_size: int = 64
    vit_max_num_patch_per_side: int = 70
    connector_act: str = "gelu_pytorch_tanh"
    interpolate_pos: bool = False
    timestep_shift: float = 1.0

    @property
    def latent_downsample(self) -> int:
        # VAE spatial downsample x latent patchify (bagel.py:71)
        return self.vae.downsample * self.latent_patch_size

    @property
    def latent_channel(self) -> int:
        return self.vae.z_channels

    @property
    def patch_latent_dim(self) -> int:
        return self.latent_patch_size**2 * self.latent_channel


def tiny_qwen2(**kw) -> Qwen2Config:
    """Small config for tests/CI."""
    base = dict(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        rope_theta=10000.0,
        max_position_embeddings=512,
    )
    base.update(kw)
    return Qwen2Config(**base)


def tiny_siglip(**kw) -> SiglipConfig:
    base = dict(
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        image_size=112,
        patch_size=14,
    )
    base.update(kw)
    return SiglipConfig(**base)


def tiny_vae(**kw) -> VAEConfig:
    base = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4)
    base.update(kw)
    return VAEConfig(**base)


def tiny_bagel(**kw) -> BagelConfig:
    base = dict(
        llm=tiny_qwen2(),
        vit=tiny_siglip(),
        vae=tiny_vae(),
        latent_patch_size=2,
        max_latent_size=16,
        vit_max_num_patch_per_side=16,
        timestep_shift=1.0,
    )
    base.update(kw)
    return BagelConfig(**base)


def micro_bagel(**kw) -> BagelConfig:
    """Smallest valid config — for gradient/sharding tests where compile
    time dominates (CPU CI)."""
    base = dict(
        llm=Qwen2Config(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
            rope_theta=10000.0, max_position_embeddings=256,
        ),
        vit=SiglipConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=1,
            num_attention_heads=2, image_size=56, patch_size=14,
        ),
        vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4),
        latent_patch_size=2,
        max_latent_size=8,
        vit_max_num_patch_per_side=8,
        timestep_shift=1.0,
    )
    base.update(kw)
    return BagelConfig(**base)


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, tuple):
        return list(obj)
    return obj


def config_to_json(cfg) -> str:
    return json.dumps(_to_jsonable(cfg), indent=2)


def bagel_config_from_json(s: str) -> BagelConfig:
    d = json.loads(s)
    llm = Qwen2Config(**d.pop("llm"))
    vit_d = d.pop("vit")
    vit = SiglipConfig(**vit_d) if vit_d is not None else None
    vae_d = d.pop("vae")
    if vae_d is not None:
        vae_d["ch_mult"] = tuple(vae_d["ch_mult"])
        vae = VAEConfig(**vae_d)
    else:
        vae = None
    return BagelConfig(llm=llm, vit=vit, vae=vae, **d)
