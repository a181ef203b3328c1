from bagel_tpu_torch.models.bagel import (
    cfg_combine,
    init_bagel_params,
    latent_to_llm,
    patchify_latent,
    shifted_timesteps,
    time_embed,
    unpatchify_latent,
)
from bagel_tpu_torch.models.qwen2 import (
    KVCache,
    embed_tokens,
    init_qwen2_params,
    kv_cache_init,
    llm_extend,
    lm_logits,
)
from bagel_tpu_torch.models.vae import init_vae_params, vae_decode

__all__ = [
    "cfg_combine", "init_bagel_params", "latent_to_llm", "patchify_latent",
    "shifted_timesteps", "time_embed", "unpatchify_latent",
    "KVCache", "embed_tokens", "init_qwen2_params", "kv_cache_init",
    "llm_extend", "lm_logits",
    "init_vae_params", "vae_decode",
]
