from bagel_tpu_torch.models.bagel import (
    cfg_combine,
    connector_apply,
    encode_vit_tokens,
    init_bagel_params,
    latent_to_llm,
    patchify_latent,
    shifted_timesteps,
    time_embed,
    unpatchify_latent,
)
from bagel_tpu_torch.models.qwen2 import (
    KVCache,
    decode_text,
    embed_tokens,
    fuse_llm_params,
    init_qwen2_params,
    kv_cache_init,
    llm_extend,
    lm_logits,
)
from bagel_tpu_torch.models.siglip import (
    init_siglip_params,
    segment_flash_attention,
    siglip_encode,
)
from bagel_tpu_torch.models.vae import init_vae_params, vae_decode

__all__ = [
    "cfg_combine", "connector_apply", "encode_vit_tokens", "init_bagel_params",
    "latent_to_llm", "patchify_latent", "shifted_timesteps", "time_embed",
    "unpatchify_latent",
    "KVCache", "decode_text", "embed_tokens", "fuse_llm_params", "init_qwen2_params",
    "kv_cache_init",
    "llm_extend", "lm_logits",
    "init_siglip_params", "segment_flash_attention", "siglip_encode",
    "init_vae_params", "vae_decode",
]
