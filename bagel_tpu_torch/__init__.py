"""bagel_tpu_torch: the PyTorch/CUDA port of bagel_tpu for NVIDIA Hopper.

Module paths and function names mirror `bagel_tpu`, so each function has a
named counterpart there, and public functions keep the JAX layouts
([B, T, H, D] attention, stacked [L, ...] layer weights, [in, out] weights,
NHWC images). The package imports torch, numpy and the standard library,
never JAX and never `bagel_tpu`.

Entry points (`BagelEngine`, `init_bagel_params`, `kv_cache_init`) run on
CUDA unless the caller passes `device="cpu"`; with no device and no GPU they
raise. The hand-written kernels, each built with nvcc at first use:
`ops.flash`'s `flash_cached_attention` (`csrc/flash_cached_attention.cu`:
every LLM attention) and `flash_cached_attention_q8`
(`csrc/flash_cached_attention_q8.cu`: the int8 attention under
`BAGEL_FLASH_INT8`), `ops.sparse_flash`'s `sparse_packed_attention`
(`csrc/sparse_packed_attention.cu`: the SigLIP tower's attention),
`ops.int8_matmul` (`csrc/int8_matmul.cu`: every w8a8 linear) and
`ops.int4_matmul` (`csrc/int4_matmul.cu`: int4 linears at decode).
`utils.quant.quantize_bagel_params(params, mode)` quantizes a tree for
serving ("int8", "w8a8", "int4", "nf4").
"""

__version__ = "0.1.0"

from bagel_tpu_torch.configs import (
    BagelConfig,
    Qwen2Config,
    SiglipConfig,
    VAEConfig,
    micro_bagel,
    tiny_bagel,
    tiny_qwen2,
    tiny_siglip,
    tiny_vae,
)

__all__ = [
    "BagelConfig",
    "Qwen2Config",
    "SiglipConfig",
    "VAEConfig",
    "micro_bagel",
    "tiny_bagel",
    "tiny_qwen2",
    "tiny_siglip",
    "tiny_vae",
]
