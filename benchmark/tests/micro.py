"""A micro configuration and micro traffic of each kind, for driving the
harness on the CPU in tests (the plain versions of the kernels run there)."""

from __future__ import annotations

import copy
import json
import os

import torch

from benchmark.harness.runstate import Run
from benchmark.harness.trace import Tracer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODEL = {
    "visual_gen": True, "visual_und": True,
    "llm": {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
            "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
            "rope_theta": 10000.0, "max_position_embeddings": 1024, "qk_norm": True,
            "layer_module": "mot"},
    "vit": {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 2, "image_size": 56, "patch_size": 14},
    "vae": {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1, "z_channels": 4},
    "latent_patch_size": 2, "max_latent_size": 8, "vit_max_num_patch_per_side": 4,
    "timestep_shift": 3.0,
}
VAE_DEFAULTS = {"resolution": 256, "in_channels": 3, "out_ch": 3, "scale_factor": 0.3611,
                "shift_factor": 0.1159}

T2I = {"kind": "t2i_closed", "clients": 1, "requests": 4, "block": 2, "prompt_tokens": [4, 12], "px": 32,
       "num_timesteps": 6, "warmup_timesteps": 3, "cfg_text_scale": 4.0, "cfg_img_scale": 1.5,
       "cfg_interval": [0.4, 1.0], "timestep_shift": 3.0, "cfg_renorm_type": "global"}
CHAT = {"kind": "chat_closed", "clients": 2, "slots": 2, "decode_chunk": 4, "block": 4,
        "blocks": 2, "image_share": 0.25, "text_tokens": [8, 32], "question_tokens": [4, 8],
        "answer_tokens": [3, 8], "image_side": [28, 56], "aspect": [0.75, 1.3333], "patch": 14,
        "max_patches": 4, "base_images": 2, "warmup_requests": 2, "warmup_timeout_s": 60,
        "request_timeout_s": 60, "trace_seconds": 0.05, "check_requests": 3}
LIMITS = {"t2i_closed": {"velocity_gap": 1e-3, "combine_gap": 1e-5, "image_share": 0.1},
          "chat_closed": {"logit_gap": 1e-3}}


def model() -> dict:
    m = copy.deepcopy(MODEL)
    m["vae"].update(VAE_DEFAULTS)
    return m


def make_run(kind: str, seed: int = 7, seconds: float = 0.5, **traffic) -> Run:
    mix = dict(T2I if kind == "t2i_closed" else CHAT, **traffic)
    cell = {"name": f"micro.{kind}", "chips": 1, "traffic": mix, "limits": LIMITS[kind]}
    config = {"name": "micro", "max_kv": 512, "dtype": "float32", "model": model()}
    return Run(cell=cell, config=config, seed=seed, seconds=seconds,
               device=torch.device("cpu"), tracer=Tracer(False))


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)
