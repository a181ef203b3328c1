"""The system under test, built as its serving app builds it
(`bagel_tpu_torch/serving/app.py` `build_engine`): the weights the
benchmark made, the decoder's q/k/v and gate/up fused in place, a
`BagelEngine` over them with the mock tokenizer."""

from __future__ import annotations

import json


def bagel_config(model: dict):
    from bagel_tpu_torch.configs import bagel_config_from_json

    return bagel_config_from_json(json.dumps(model))


def build_kernels() -> None:
    """Every kernel source of the port at once (one nvcc each, in
    parallel), where the package offers it; otherwise each builds at its
    first call, which the warm-up makes."""
    try:
        from bagel_tpu_torch.ops import _build
    except ImportError:
        return
    if hasattr(_build, "build_all") and hasattr(_build, "kernel_names"):
        _build.build_all(_build.kernel_names())


def engine(run, params: dict):
    """The engine over `params` (consumed). With `run.state["quant"]` set
    (the control of `benchmark/tools/readings.py`: "w8a8") the decoder's
    weights are quantized first, as the app's `--quant` does."""
    from bagel_tpu_torch.data.tokenizer import MockTokenizer
    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.models.qwen2 import fuse_llm_params

    tok = MockTokenizer(run.model["llm"]["vocab_size"])
    quant = run.state.get("quant")
    if quant:
        from bagel_tpu_torch.utils.quant import quantize_llm_params

        params["llm"] = quantize_llm_params(params["llm"], quant)
    params["llm"] = fuse_llm_params(params["llm"], inplace=True)
    return BagelEngine(params, bagel_config(run.model), tok, tok.new_token_ids,
                       max_kv=run.config["max_kv"], device=run.device)
