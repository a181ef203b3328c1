"""HTTP serving API over the continuous-batching runtime (port of
bagel_tpu/serving/server.py; standard library, with PIL for the PNG wire
format, imported where an image is decoded or encoded).

Endpoints (JSON in, JSON out; images are base64-encoded PNG):

  GET  /healthz      -> {"ok": true}
  GET  /v1/stats     -> the runtime's counters and slot occupancy
  POST /v1/chat      {"prompt", "image"? | "images"? (list), "max_tokens"?,
                      "think"?, "stream"?}             -> {"text"}
                     with "stream": NDJSON events {"text_delta"} per decode
                     chunk, then {"done": true, "text"}
  POST /v1/generate  {"prompt", "image"? (edit), "image_size"?,
                      "num_timesteps"?, "cfg_text_scale"?, "cfg_img_scale"?,
                      "cfg_renorm_type"?, "seed"?}     -> {"image", "shape"}

A ThreadingHTTPServer gives each connection a thread that enqueues into the
runtime and waits on its Future, so chats from many clients share decode
chunks while generate jobs run between chunks; all device work stays on the
runtime's scheduler thread. A "seed" becomes a `torch.Generator` seeded
with it on the engine's device (JAX's server makes a PRNGKey: the two draw
different numbers from one seed).

  python -m bagel_tpu_torch.serving.server [--checkpoint DIR] [--kv_quant] \
      [--slots 8] [--port 8000] [--device cpu]

Under torchrun (a torch.distributed group of several processes) every
process runs `main`: each builds its engine (its shards with `--mesh`),
and the frontend is `serving.multihost.serve_multihost`: rank 0 serves
HTTP, the others tick in lockstep until it stops (JAX's server.py:320-345).
"""

from __future__ import annotations

import argparse
import base64
import io
import itertools
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

_GEN_KEYS = {
    "image_size", "num_timesteps", "cfg_text_scale", "cfg_img_scale",
    "cfg_interval", "cfg_renorm_type", "cfg_renorm_min", "timestep_shift",
}


def decode_png(b64: str, transform) -> np.ndarray:
    """A base64 image (PNG on the wire) -> `transform` of its RGB pixels
    (an `ImageTransform`: HWC float32 in [-1, 1])."""
    from PIL import Image

    from bagel_tpu_torch.data.transforms import pil_img2rgb

    return transform(pil_img2rgb(Image.open(io.BytesIO(base64.b64decode(b64)))))


def encode_png(arr: np.ndarray) -> str:
    """HWC uint8 -> base64 PNG."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


class BagelServer:
    """Owns the runtime and the transforms and translates HTTP payloads."""

    def __init__(self, runtime, vae_tf, vit_tf, request_timeout: float = 3600.0):
        self.runtime = runtime
        self.vae_tf = vae_tf
        self.vit_tf = vit_tf
        self.request_timeout = request_timeout

    def _chat_images(self, body: dict):
        """'image' (one base64 PNG) or 'images' (a list) -> the runtime's
        image argument; each image becomes its own non-causal block."""
        if body.get("images"):
            return [decode_png(b, self.vit_tf) for b in body["images"]]
        if body.get("image"):
            return decode_png(body["image"], self.vit_tf)
        return None

    def chat(self, body: dict) -> dict:
        prompt = body.get("prompt")
        if not prompt:
            raise ValueError("'prompt' is required")
        image = self._chat_images(body)
        if body.get("think"):
            # think mode decodes one session at a time: the runtime's
            # exclusive-job queue (understanding through engine.__call__)
            if isinstance(image, list):
                if len(image) != 1:
                    raise ValueError("think mode supports a single image")
                image = image[0]
            fut = self.runtime.submit_generate(
                prompt, image=image, understanding_output=True, think=True,
                max_think_token_n=body.get("max_tokens") or 512,
            )
            return {"text": fut.result(timeout=self.request_timeout)["text"]}
        fut = self.runtime.submit_chat(prompt, image=image, max_new_tokens=body.get("max_tokens"))
        return {"text": fut.result(timeout=self.request_timeout)}

    def chat_stream_events(self, body: dict):
        """NDJSON events of a streaming chat: {"text_delta"} per decode
        chunk, then {"done": true, "text": full}. The scheduler thread only
        enqueues the token ids; they are decoded here, on the handler's
        thread, so a slow client never holds up the decode loop."""
        prompt = body.get("prompt")
        if not prompt:
            raise ValueError("'prompt' is required")
        if body.get("think"):
            # think mode has no token hook: one final event
            yield {"done": True, "text": self.chat(body)["text"]}
            return
        image = self._chat_images(body)
        chunks: "queue.Queue[list]" = queue.Queue()
        fut = self.runtime.submit_chat(prompt, image=image,
                                       max_new_tokens=body.get("max_tokens"),
                                       on_tokens=chunks.put)
        tok = self.runtime.engine.tokenizer
        produced: list = []
        seen = ""

        def drain(ids):
            nonlocal seen
            produced.extend(ids)
            text = tok.decode(produced)
            if len(text) > len(seen):
                delta, seen = text[len(seen):], text
                return {"text_delta": delta}
            return None

        deadline = time.monotonic() + self.request_timeout
        while True:
            try:
                ev = drain(chunks.get(timeout=0.05))
                if ev:
                    yield ev
            except queue.Empty:
                if fut.done():
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError("stream timed out")
        while not chunks.empty():
            ev = drain(chunks.get_nowait())
            if ev:
                yield ev
        yield {"done": True, "text": fut.result(timeout=5)}

    def generate(self, body: dict) -> dict:
        kw = {k: body[k] for k in _GEN_KEYS if k in body}
        size = kw.pop("image_size", None)
        if size is not None:
            kw["image_shapes"] = (size, size) if isinstance(size, int) else tuple(size)
        if "seed" in body:
            kw["rng"] = torch.Generator(device=self.runtime.engine.device).manual_seed(
                int(body["seed"]))
        image = None
        if body.get("image"):  # an edit: the source image through the VAE pathway
            image = decode_png(body["image"], self.vae_tf)
            # the upstream edit path renorms per text channel
            kw.setdefault("cfg_renorm_type", "text_channel")
        fut = self.runtime.submit_generate(body.get("prompt"), image=image, **kw)
        out = fut.result(timeout=self.request_timeout)
        arr = np.asarray(out["image"] if isinstance(out, dict) else out)
        return {"image": encode_png(arr), "shape": list(arr.shape[:2])}

    def stats(self) -> dict:
        """/v1/stats: the runtime's counters (`ServingRuntime.stats`;
        besides the chunk and token counts, admitted, queue_wait_s and
        requeued: the chat requests admitted, their summed seconds from
        submission to the start of their prefill, and the put-backs of
        requests that had to wait for KV capacity), and the slots and
        queues now."""
        rt = self.runtime
        return {
            **rt.stats,
            "slots": rt.slots,
            "slots_busy": sum(s is not None for s in rt.slot_state),
            "queued_chat": rt.chat_q.qsize(),
            "queued_gen": rt.gen_q.qsize(),
        }


def _make_handler(server: BagelServer):
    class Handler(BaseHTTPRequestHandler):
        # chunked transfer (streaming) needs HTTP/1.1; every other reply
        # sends a Content-Length, so keep-alive is safe
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # the stats carry the counters
            pass

        def _reply(self, code: int, payload: dict):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _stream(self, events):
            """Chunked NDJSON, one event a line. The headers are sent first,
            so a failure mid-stream ends the stream with an in-band
            {"error": ...} event and a clean last chunk."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def write_event(ev):
                data = json.dumps(ev).encode() + b"\n"
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data + b"\r\n")
                self.wfile.flush()

            try:
                for ev in events:
                    write_event(ev)
            except Exception as e:  # noqa: BLE001  reported in band
                write_event({"error": f"{type(e).__name__}: {e}"})
            self.wfile.write(b"0\r\n\r\n")

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/v1/stats":
                self._reply(200, server.stats())
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except ValueError as e:  # json.JSONDecodeError is a ValueError
                return self._reply(400, {"error": f"bad json: {e}"})
            try:
                if self.path == "/v1/chat" and body.get("stream"):
                    events = server.chat_stream_events(body)
                    first = next(events)  # validation errors land before the headers
                    self._stream(itertools.chain([first], events))
                elif self.path == "/v1/chat":
                    self._reply(200, server.chat(body))
                elif self.path == "/v1/generate":
                    self._reply(200, server.generate(body))
                else:
                    self._reply(404, {"error": f"no route {self.path}"})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001  a scheduler or engine failure
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(server: BagelServer, host: str = "127.0.0.1", port: int = 8000) -> ThreadingHTTPServer:
    """Bind and return the HTTP server (port=0 picks a free port: read it
    from `httpd.server_address`)."""
    httpd = ThreadingHTTPServer((host, port), _make_handler(server))
    httpd.daemon_threads = True
    return httpd


def serve_in_thread(server: BagelServer, host: str = "127.0.0.1", port: int = 0):
    """(httpd, thread), already serving on a thread of its own; end it with
    `httpd.shutdown()` and `httpd.server_close()`."""
    httpd = serve(server, host, port)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t


def main(argv: Optional[list] = None):
    from bagel_tpu_torch.serving.app import build_engine, parse_args
    from bagel_tpu_torch.serving.multihost import serve_multihost
    from bagel_tpu_torch.serving.runtime import ServingRuntime
    from bagel_tpu_torch.utils.device import process_rank_world, resolve_device

    ap = argparse.ArgumentParser("bagel_tpu_torch http server", add_help=False)
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--decode_chunk", type=int, default=16)
    ap.add_argument("--ngram", type=int, default=3)
    ap.add_argument("--gen_batch", type=int, default=1,
                    help="N > 1: queued text-to-image jobs that share shape and CFG "
                         "parameters run as one batched denoise")
    own, rest = ap.parse_known_args(argv)
    args = parse_args(rest)
    # the group first (under torchrun): it picks each process's card
    rank, world, _ = process_rank_world(resolve_device(args.device))
    engine, vae_tf, vit_tf = build_engine(args)
    kw = dict(slots=own.slots, decode_chunk=own.decode_chunk, mesh=engine.mesh,
              speculative=args.speculative, ngram=own.ngram, gen_batch=own.gen_batch)
    if world > 1:
        # every process runs this program; rank 0 also takes HTTP traffic and
        # broadcasts it before each scheduler tick (serving/multihost.py)
        rt = serve_multihost(engine, **kw)
        rt.start()
        if not rt.leader:
            print(f"bagel_tpu_torch follower (process {rank}) ticking until the leader stops")
            rt.join()
            if rt.error is not None:
                raise rt.error
            return
    else:
        rt = ServingRuntime(engine, **kw)
        rt.start()
    httpd = serve(BagelServer(rt, vae_tf, vit_tf), own.host, args.port)
    print(f"bagel_tpu_torch serving on http://{own.host}:{httpd.server_address[1]} "
          f"(slots={own.slots})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        rt.stop()


if __name__ == "__main__":
    main()
