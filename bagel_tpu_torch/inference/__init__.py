from bagel_tpu_torch.inference.engine import BagelEngine, GenContext

__all__ = ["BagelEngine", "GenContext"]
