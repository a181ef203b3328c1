"""Serving entry point (port of bagel_tpu/serving/app.py).

Loads a released BAGEL checkpoint (or, without one, a random micro model
for a demo: `demo_config`) and serves the three modes (text-to-image,
edit, understand, each with think mode) through a Gradio UI when gradio is
installed, else an interactive prompt, or once from the command line. `serving/server.py`
serves the same engine over HTTP.

  python -m bagel_tpu_torch.serving.app [--checkpoint /path/to/BAGEL-7B-MoT] \
      [--mode t2i] [--prompt "..."] [--output out.png] [--device cpu]

The engine runs on CUDA unless `--device` names another device.

`--mesh dp,fsdp,tp` shards the weights over that mesh of processes (JAX's
GSPMD-sharded serving, app.py:123-141; here `parallel.mesh.
InferenceLayout`), one process a mesh entry under torchrun:

  torchrun --nproc_per_node 2 -m bagel_tpu_torch.serving.server --mesh 1,1,2

The shape's product must equal the processes' number. Each leaf is cut
to this process's shard as it is placed (quantized on the whole leaf
first with `--quant`); `engine.mesh` is the mesh, over which the serving
runtime shards its slot cache.
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser("bagel_tpu_torch server")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="released checkpoint dir; omit for a random micro demo")
    p.add_argument("--mesh", type=str, default=None,
                   help="dp,fsdp,tp: shard the weights over this mesh of processes "
                        "(torchrun; the product equals WORLD_SIZE)")
    p.add_argument("--device", type=str, default=None,
                   help="the engine's device (default: CUDA)")
    p.add_argument("--max_kv", type=int, default=8192)
    p.add_argument("--max_latent_size", type=int, default=64)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--share", action="store_true")
    # one-shot CLI mode (no UI)
    p.add_argument("--mode", type=str, default=None, choices=["t2i", "edit", "understand"])
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--image", type=str, default=None)
    p.add_argument("--output", type=str, default="output.png")
    p.add_argument("--think", action="store_true")
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--num_timesteps", type=int, default=50)
    p.add_argument("--cfg_text_scale", type=float, default=4.0)
    p.add_argument("--cfg_img_scale", type=float, default=1.5)
    p.add_argument("--cfg_renorm_type", type=str, default=None,
                   help="default: global for t2i, text_channel for edit (the upstream "
                        "edit path's renorm)")
    p.add_argument("--timestep_shift", type=float, default=3.0)
    p.add_argument("--enable_taylorseer", action="store_true")
    p.add_argument("--taylorseer_threshold", type=int, default=3,
                   help="a full forward every Nth step (upstream default 3)")
    p.add_argument("--taylorseer_first_enhance", type=int, default=5,
                   help="full warm-up steps (upstream default 5)")
    p.add_argument("--quant", type=str, default=None,
                   choices=[None, "int8", "w8a8", "int4", "nf4"],
                   help="LLM quantization: int8 per-column weight-only, w8a8 int8 weights "
                        "and per-token int8 activations, int4 / nf4 per-group 4-bit")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--speculative", type=int, default=0,
                   help="K > 0: prompt-lookup speculative decode for text outputs "
                        "(greedy-exact; inference/speculative.py)")
    p.add_argument("--no_fuse", action="store_true",
                   help="keep separate q/k/v and gate/up projections")
    p.add_argument("--zh", action="store_true", help="Chinese UI labels")
    p.add_argument("--kv_quant", action="store_true",
                   help="int8 KV cache for chat and serving sessions (half the cache's "
                        "bytes, so about twice the slots; generation contexts stay bf16)")
    return p.parse_args(argv)


def demo_config(device: torch.device):
    """(config, dtype) of the random demo model that runs without a
    checkpoint: the JAX package's micro depth (one layer each) at the
    kernels' head dims (LLM 128, SigLIP 72), so that its attention runs
    through them on CUDA; fp32 on the CPU, bf16 on CUDA."""
    from bagel_tpu_torch.configs import Qwen2Config, SiglipConfig, micro_bagel

    cfg = micro_bagel(
        llm=Qwen2Config(vocab_size=128, hidden_size=256, intermediate_size=256,
                        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
                        rope_theta=10000.0, max_position_embeddings=256),
        vit=SiglipConfig(hidden_size=144, intermediate_size=128, num_hidden_layers=1,
                         num_attention_heads=2, image_size=56, patch_size=14),
    )
    return cfg, torch.bfloat16 if device.type == "cuda" else torch.float32


def inference_layout(mesh_arg: str, cfg, device):
    """The layout of `--mesh dp,fsdp,tp` over this process group (started
    from torchrun's environment if it is not yet: nccl on CUDA, gloo on the
    CPU); the shape's product must be its size."""
    from bagel_tpu_torch.parallel.mesh import InferenceLayout, make_mesh
    from bagel_tpu_torch.utils.device import process_rank_world

    shape = tuple(int(x) for x in mesh_arg.split(","))
    if len(shape) != 3:
        raise ValueError(f"--mesh takes dp,fsdp,tp, got {mesh_arg!r}")
    process_rank_world(device)
    return InferenceLayout(make_mesh(shape), cfg)


def build_engine(args):
    """(engine, vae_transform, vit_transform) from parsed arguments."""
    from bagel_tpu_torch.data.transforms import ImageTransform
    from bagel_tpu_torch.inference.engine import BagelEngine
    from bagel_tpu_torch.models.qwen2 import fuse_llm_params
    from bagel_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.checkpoint:
        from bagel_tpu_torch.configs import BagelConfig, Qwen2Config, SiglipConfig, VAEConfig

        cfg = BagelConfig(llm=Qwen2Config(), vit=SiglipConfig(), vae=VAEConfig(),
                          max_latent_size=args.max_latent_size, timestep_shift=3.0)
    else:
        cfg, dtype = demo_config(device)
    layout = inference_layout(args.mesh, cfg, device) if args.mesh else None
    # each leaf cut to this process's shard as it is placed; with --quant
    # each whole leaf is quantized first, then cut (below)
    cut = None if args.quant else layout
    if args.checkpoint:
        from bagel_tpu_torch.data.tokenizer import load_tokenizer
        from bagel_tpu_torch.utils.bridge import params_to
        from bagel_tpu_torch.utils.convert import load_checkpoint_dir

        # f32 leaves to bf16, as the JAX app does
        params = params_to(load_checkpoint_dir(args.checkpoint, cfg), device,
                           dtype=torch.bfloat16, layout=cut)
        tokenizer, new_token_ids, _ = load_tokenizer(args.checkpoint)
    else:
        from bagel_tpu_torch.data.tokenizer import MockTokenizer
        from bagel_tpu_torch.models.bagel import init_bagel_params

        params = init_bagel_params(torch.Generator(device=device).manual_seed(0), cfg,
                                   dtype, device=device, place=cut and cut.place)
        tokenizer = MockTokenizer(cfg.llm.vocab_size)
        new_token_ids = tokenizer.new_token_ids

    if args.quant:
        from bagel_tpu_torch.utils.quant import quantize_bagel_params

        params = quantize_bagel_params(params, args.quant)
        if layout is not None:
            params = layout.place_tree(params)
    if not args.no_fuse:
        # after quantization, so that the leaves concatenate with their
        # per-output-channel scales; a shard's q, k, v (gate, up) fuse into
        # its shard of the fused leaf
        params["llm"] = fuse_llm_params(params["llm"], inplace=True)

    stride = cfg.latent_downsample
    if args.checkpoint:
        vae_tf = ImageTransform(1024, 512, stride)
        vit_tf = ImageTransform(980, 378, cfg.vit.patch_size)
    else:
        vae_tf = ImageTransform(64, 16, stride, max_pixels=64 * 64)
        vit_tf = ImageTransform(56, 28, cfg.vit.patch_size, max_pixels=56 * 56)
    engine = BagelEngine(params, cfg, tokenizer, new_token_ids, max_kv=args.max_kv,
                         vae_transform=vae_tf, vit_transform=vit_tf,
                         kv_quant=getattr(args, "kv_quant", False), device=device,
                         layout=layout)
    return engine, vae_tf, vit_tf


def _load_image(path, transform):
    from PIL import Image

    from bagel_tpu_torch.data.transforms import pil_img2rgb

    return transform(pil_img2rgb(Image.open(path)))


def run_once(engine, vae_tf, vit_tf, args):
    """One request from the command line (--mode); prints the text, saves
    the image to --output."""
    rng = torch.Generator(device=engine.device).manual_seed(args.seed)
    # an edit renorms per text channel by default, as the upstream edit path
    renorm = args.cfg_renorm_type or ("text_channel" if args.mode == "edit" else "global")
    kwargs = dict(
        think=args.think,
        speculative=args.speculative,
        cfg_text_scale=args.cfg_text_scale,
        cfg_img_scale=args.cfg_img_scale,
        cfg_renorm_type=renorm,
        timestep_shift=args.timestep_shift,
        num_timesteps=args.num_timesteps,
        image_shapes=(args.image_size, args.image_size),
        enable_taylorseer=args.enable_taylorseer,
        taylorseer_threshold=args.taylorseer_threshold,
        taylorseer_first_enhance=args.taylorseer_first_enhance,
        rng=rng,
    )
    if args.mode == "understand":
        # understanding takes the ViT pathway: the stride-14 resize
        image = _load_image(args.image, vit_tf) if args.image else None
        out = engine(image=image, text=args.prompt, understanding_output=True,
                     think=args.think, speculative=args.speculative)
        print(out["text"])
        return out
    image = _load_image(args.image, vae_tf) if args.image else None
    out = engine(image=image, text=args.prompt, **kwargs)
    if out.get("text"):
        print(out["text"])
    if out.get("image") is not None:
        from PIL import Image

        Image.fromarray(out["image"]).save(args.output)
        print(f"saved {args.output}")
    return out


# UI labels behind --zh
ZH_LABELS = {
    "Text to Image": "文生图",
    "Edit": "图像编辑",
    "Understand": "图像理解",
    "prompt": "提示词",
    "instruction": "编辑指令",
    "question": "问题",
    "answer": "回答",
    "thinking": "思考过程",
    "think mode": "思考模式",
    "generate": "生成",
    "edit": "编辑",
    "ask": "提问",
    "size": "尺寸",
    "timesteps": "采样步数",
    "seed": "随机种子",
}


def _label(text, zh):
    return ZH_LABELS.get(text, text) if zh else text


def launch_ui(engine, vae_tf, vit_tf, args):
    import gradio as gr

    def L(text):
        return _label(text, args.zh)

    spec = args.speculative  # text decodes, think included

    def seeded(seed):
        return torch.Generator(device=engine.device).manual_seed(int(seed))

    def t2i(prompt, think, size, steps, cfg_text, cfg_img, shift, renorm, seed):
        out = engine(text=prompt, think=think, image_shapes=(int(size), int(size)),
                     num_timesteps=int(steps), cfg_text_scale=cfg_text, cfg_img_scale=cfg_img,
                     timestep_shift=shift, cfg_renorm_type=renorm, rng=seeded(seed),
                     speculative=spec)
        return out.get("image"), out.get("text") or ""

    def edit(image, prompt, think, steps, cfg_text, cfg_img, shift, seed):
        out = engine(image=vae_tf(image), text=prompt, think=think, num_timesteps=int(steps),
                     cfg_text_scale=cfg_text, cfg_img_scale=cfg_img, timestep_shift=shift,
                     cfg_renorm_type="text_channel", rng=seeded(seed), speculative=spec)
        return out.get("image"), out.get("text") or ""

    def understand(image, prompt, think):
        out = engine(image=vit_tf(image), text=prompt, understanding_output=True, think=think,
                     speculative=spec)
        return out.get("text") or ""

    with gr.Blocks(title="BAGEL") as demo:
        with gr.Tab(L("Text to Image")):
            prompt = gr.Textbox(label=L("prompt"))
            with gr.Row():
                size = gr.Slider(256, 1024, 1024, step=64, label=L("size"))
                steps = gr.Slider(4, 100, 50, step=1, label=L("timesteps"))
                cfg_text = gr.Slider(1, 8, 4.0, label=L("cfg_text_scale"))
                cfg_img = gr.Slider(1, 2, 1.0, label=L("cfg_img_scale"))
                shift = gr.Slider(1, 5, 3.0, label=L("timestep_shift"))
                renorm = gr.Dropdown(["global", "channel", "text_channel"], value="global",
                                     label=L("cfg_renorm"))
                seed = gr.Number(42, label=L("seed"))
            think = gr.Checkbox(label=L("think mode"))
            btn = gr.Button(L("generate"))
            img_out = gr.Image()
            txt_out = gr.Textbox(label=L("thinking"))
            btn.click(t2i, [prompt, think, size, steps, cfg_text, cfg_img, shift, renorm, seed],
                      [img_out, txt_out])
        with gr.Tab(L("Edit")):
            src = gr.Image(type="pil")
            eprompt = gr.Textbox(label=L("instruction"))
            with gr.Row():
                esteps = gr.Slider(4, 100, 50, step=1, label=L("timesteps"))
                ecfg_t = gr.Slider(1, 8, 4.0, label=L("cfg_text_scale"))
                ecfg_i = gr.Slider(1, 2, 2.0, label=L("cfg_img_scale"))
                eshift = gr.Slider(1, 5, 3.0, label=L("timestep_shift"))
                eseed = gr.Number(42, label=L("seed"))
            ethink = gr.Checkbox(label=L("think mode"))
            ebtn = gr.Button(L("edit"))
            eimg = gr.Image()
            etxt = gr.Textbox(label=L("thinking"))
            ebtn.click(edit, [src, eprompt, ethink, esteps, ecfg_t, ecfg_i, eshift, eseed],
                       [eimg, etxt])
        with gr.Tab(L("Understand")):
            uimg = gr.Image(type="pil")
            uq = gr.Textbox(label=L("question"))
            uthink = gr.Checkbox(label=L("think mode"))
            ubtn = gr.Button(L("ask"))
            uans = gr.Textbox(label=L("answer"))
            ubtn.click(understand, [uimg, uq, uthink], [uans])
    demo.launch(server_port=args.port, share=args.share)


def main(argv=None):
    args = parse_args(argv)
    engine, vae_tf, vit_tf = build_engine(args)
    if args.mode:
        return run_once(engine, vae_tf, vit_tf, args)
    try:
        import gradio  # noqa: F401
    except ImportError:
        print("gradio not installed: interactive prompt (':img path' attaches an image, "
              "':quit' exits)")
        image = None
        while True:
            try:
                line = input("> ").strip()
            except EOFError:
                break
            if line == ":quit":
                break
            if line.startswith(":img "):
                image = _load_image(line[5:], vit_tf)
                print("image attached")
                continue
            out = engine(image=image, text=line, understanding_output=True,
                         speculative=args.speculative)
            print(out["text"])
            image = None
        return None
    launch_ui(engine, vae_tf, vit_tf, args)
    return None


if __name__ == "__main__":
    main()
