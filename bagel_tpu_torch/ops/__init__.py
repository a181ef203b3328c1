from bagel_tpu_torch.ops.attention import (
    cache_block_mask,
    dot_attention,
    segment_mask,
    train_packed_mask,
)
from bagel_tpu_torch.ops.embeds import (
    flattened_position_ids_extrapolate,
    flattened_position_ids_interpolate,
    sincos_2d_grid,
    timestep_embedding,
)
from bagel_tpu_torch.ops.flash import (
    flash_cached_attention,
    flash_cached_attention_plain,
    flash_cached_attention_q8,
    flash_q8_plain,
    kv_bucket,
    q8_prep,
    q8_prep_plain,
)
from bagel_tpu_torch.ops.norms import group_norm, layer_norm, rms_norm
from bagel_tpu_torch.ops.rope import apply_rope, apply_rope_2d, rope_2d_tables, rope_cos_sin
from bagel_tpu_torch.ops.sparse_flash import (
    block_liveness,
    sparse_packed_attention,
    sparse_packed_attention_plain,
)

__all__ = [
    "cache_block_mask",
    "dot_attention",
    "segment_mask",
    "train_packed_mask",
    "flattened_position_ids_extrapolate",
    "flattened_position_ids_interpolate",
    "sincos_2d_grid",
    "timestep_embedding",
    "flash_cached_attention",
    "flash_cached_attention_plain",
    "flash_cached_attention_q8",
    "flash_q8_plain",
    "kv_bucket",
    "q8_prep",
    "q8_prep_plain",
    "group_norm",
    "layer_norm",
    "rms_norm",
    "apply_rope",
    "apply_rope_2d",
    "rope_2d_tables",
    "rope_cos_sin",
    "block_liveness",
    "sparse_packed_attention",
    "sparse_packed_attention_plain",
]
