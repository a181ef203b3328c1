"""Multi-process request routing for the continuous-batching runtime (port of
bagel_tpu/serving/multihost.py).

A tick of `ServingRuntime._tick` is deterministic given (a) the request
queues at its entry and (b) the device's outputs. Processes that hold the
same engine (replicated weights from one seed or one checkpoint, or each
its shards of one sharded engine: `BagelEngine(layout=)`, whose
collectives leave the same bits on every rank, with `mesh=engine.mesh`
for the runtime) compute the same outputs, so serving from several
processes reduces to replicating (a): the leader (rank 0) stages client
requests, broadcasts the staged ingress batch before every tick, and
every process, the leader too, then runs the same tick. The followers
stay in lockstep with no RPC layer and no routing table.

The bus is `TorchDistBus`: a pickled batch through
`torch.distributed.broadcast_object_list` on a gloo group, also when the
engines run on CUDA, so the control plane never waits on the card
(`JaxHostBus` in JAX); a sharded engine's compute collectives take the
mesh's groups. `LocalBus` fans out in memory (one process, tests).

Lockstep holds when every process draws the same numbers: the port samples
from `torch.Generator`s (ROADMAP C), so every process seeds its own
identically (the engine's defaults do), and each captures its own decode
graphs (`inference.decode_program`).

Usage (every process runs the same program, under torchrun):

    frontend = serve_multihost(engine, slots=8)
    frontend.start()
    if frontend.leader:               # rank 0: accept traffic
        serve(frontend, port=8000)    # serving/server.py's HTTP API
    else:                             # followers tick until the leader stops
        frontend.join()
    frontend.stop()

Streaming callbacks (`on_tokens`) fire on the leader only; followers run
the same decode chunks but hold futures that nobody reads.
"""

from __future__ import annotations

import pickle
import queue
import threading
from typing import List, Optional

from bagel_tpu_torch.serving.runtime import Future, ServingRuntime, _ChatRequest, _GenRequest


class LocalBus:
    """In-memory leader -> followers fanout (one process: the lockstep
    tests, a single-host deployment)."""

    def __init__(self, n_followers: int = 0):
        self._qs = [queue.Queue() for _ in range(n_followers)]

    def send(self, payload: bytes):
        for q in self._qs:
            q.put(payload)

    def recv(self, follower_idx: int = 0) -> bytes:
        return self._qs[follower_idx].get()


class TorchDistBus:
    """Leader -> all broadcast over torch.distributed: the pickled payload
    through `broadcast_object_list` from rank 0 on a gloo group of every
    process (its own, so that the engines' nccl group, if any, never
    carries the control plane). Collective: every process builds it."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group if group is not None else dist.new_group(backend="gloo")

    def _bcast(self, payload: Optional[bytes]) -> bytes:
        import torch.distributed as dist

        box = [payload]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def send(self, payload: bytes):
        self._bcast(payload)

    def recv(self, follower_idx: int = 0) -> bytes:
        return self._bcast(None)


def _pack_chat(req: _ChatRequest) -> tuple:
    return ("chat", req.prompt, req.image, req.max_new_tokens)


def _pack_gen(req: _GenRequest) -> tuple:
    return ("gen", req.kwargs)


def _unpack(rec: tuple):
    if rec[0] == "chat":
        return _ChatRequest(rec[1], rec[2], rec[3], Future())
    return _GenRequest(rec[1], Future())


class MultiHostFrontend:
    """Lockstep driver around a ServingRuntime.

    Leader: `submit_chat` / `submit_generate` stage requests; the drive loop
    broadcasts `(staged, stop)` then runs `runtime._tick()`. Followers:
    receive, enqueue the same requests (with futures nobody reads), run the
    same tick. `ticks` counts the ticks run."""

    def __init__(self, runtime: ServingRuntime, bus=None, leader: bool = True,
                 follower_idx: int = 0, idle_wait: float = 0.05):
        self.runtime = runtime
        self.bus = bus
        self.leader = leader
        self.follower_idx = follower_idx
        self.idle_wait = idle_wait
        self.ticks = 0
        self._staged: List[tuple] = []
        self._staged_reqs: List[object] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    # -- client API (leader only) -------------------------------------------

    def _stage(self, rec: tuple, req) -> None:
        if not self.leader:
            raise RuntimeError("followers take no client traffic: send requests to the leader")
        with self._lock:
            self._staged.append(rec)
            self._staged_reqs.append(req)
        self._wake.set()

    def submit_chat(self, prompt: str, image=None, max_new_tokens: Optional[int] = None,
                    on_tokens=None) -> Future:
        req = _ChatRequest(prompt, image, max_new_tokens or self.runtime.max_new_default,
                           Future(), on_tokens)
        self._stage(_pack_chat(req), req)
        return req.future

    def submit_generate(self, prompt: Optional[str] = None, image=None, **kwargs) -> Future:
        kw = dict(kwargs)
        if prompt is not None:
            kw["text"] = prompt
        if image is not None:
            kw["image"] = image
        req = _GenRequest(kw, Future())
        self._stage(_pack_gen(req), req)
        return req.future

    @property
    def stats(self):
        return self.runtime.stats

    # the HTTP server (serving/server.py) reads these off its runtime
    @property
    def engine(self):
        return self.runtime.engine

    @property
    def slots(self):
        return self.runtime.slots

    @property
    def slot_state(self):
        return self.runtime.slot_state

    @property
    def chat_q(self):
        return self.runtime.chat_q

    @property
    def gen_q(self):
        return self.runtime.gen_q

    # -- lifecycle ------------------------------------------------------------

    def start(self):
        if self._thread is not None:
            raise RuntimeError("the frontend is already running")
        self._thread = threading.Thread(target=self._drive, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 60.0):
        self._stop.set()
        self._wake.set()
        self.join(timeout)

    def join(self, timeout: Optional[float] = None):
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -- lockstep loop ---------------------------------------------------------

    def _enqueue(self, packed: List[tuple], reqs: Optional[List[object]]):
        rt = self.runtime
        for i, rec in enumerate(packed):
            req = reqs[i] if reqs is not None else _unpack(rec)
            (rt.chat_q if rec[0] == "chat" else rt.gen_q).put(req)

    def _drive(self):
        rt = self.runtime
        try:
            rt.enter_device()
            while True:
                if self.leader:
                    with self._lock:
                        packed, reqs = self._staged, self._staged_reqs
                        self._staged, self._staged_reqs = [], []
                    stop = self._stop.is_set()
                    if self.bus is not None:
                        self.bus.send(pickle.dumps((packed, stop)))
                    self._enqueue(packed, reqs)
                else:
                    packed, stop = pickle.loads(self.bus.recv(self.follower_idx))
                    self._enqueue(packed, None)
                if stop:
                    rt._drain()
                    return
                busy = rt._tick()
                self.ticks += 1
                # the leader throttles empty ticks; followers stay blocked in
                # recv() until the leader's next broadcast, so they never spin
                if self.leader and not busy and rt.chat_q.empty():
                    with self._lock:
                        idle = not self._staged
                    if idle:
                        self._wake.wait(timeout=self.idle_wait)
                        self._wake.clear()
        except BaseException as e:  # noqa: BLE001  a lost bus fails what waits, then shows here
            self.error = e
            rt._drain()


def serve_multihost(engine, bus=None, **runtime_kwargs) -> MultiHostFrontend:
    """The lockstep frontend of this process. Under a torch.distributed
    group of several processes (each with the same engine, or its shards of
    a sharded one: pass `mesh=engine.mesh`) rank 0 leads over a
    `TorchDistBus`; one process falls back to a plain leader with no bus
    (no cost over a ServingRuntime)."""
    import torch.distributed as dist

    rt = ServingRuntime(engine, **runtime_kwargs)
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return MultiHostFrontend(rt, bus=bus, leader=True)
    return MultiHostFrontend(rt, bus=bus or TorchDistBus(), leader=dist.get_rank() == 0)
