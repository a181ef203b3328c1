from bagel_tpu_torch.ops.attention import cache_block_mask, dot_attention
from bagel_tpu_torch.ops.embeds import (
    flattened_position_ids_extrapolate,
    flattened_position_ids_interpolate,
    sincos_2d_grid,
    timestep_embedding,
)
from bagel_tpu_torch.ops.flash import (
    flash_cached_attention,
    flash_cached_attention_plain,
    kv_bucket,
)
from bagel_tpu_torch.ops.norms import group_norm, layer_norm, rms_norm
from bagel_tpu_torch.ops.rope import apply_rope, rope_cos_sin

__all__ = [
    "cache_block_mask",
    "dot_attention",
    "flattened_position_ids_extrapolate",
    "flattened_position_ids_interpolate",
    "sincos_2d_grid",
    "timestep_embedding",
    "flash_cached_attention",
    "flash_cached_attention_plain",
    "kv_bucket",
    "group_norm",
    "layer_norm",
    "rms_norm",
    "apply_rope",
    "rope_cos_sin",
]
