from bagel_tpu_torch.inference.engine import (
    GEN_THINK_SYSTEM_PROMPT,
    VLM_THINK_SYSTEM_PROMPT,
    BagelEngine,
    GenContext,
)

__all__ = [
    "BagelEngine",
    "GenContext",
    "VLM_THINK_SYSTEM_PROMPT",
    "GEN_THINK_SYSTEM_PROMPT",
]
