"""Decode as one program: the counterpart of the JAX package's compiled
decode loops, `_decode_jit` (bagel_tpu/inference/engine.py:1070-1080, behind
`gen_text` and `chat_batch`) and the serving runtime's `_decode_chunk_jit` /
`_decode_spec_chunk_jit` (bagel_tpu/serving/runtime.py:111-140), all over the
`lax.while_loop`s of `qwen2.decode_text` and `speculative.decode_text_spec`.

JAX compiles the whole loop into one program. PyTorch runs eagerly: at full
width a decode step is ~1700 launches, and the host's work to issue them
takes several times the device's. So a `DecodeProgram` captures `chunk`
steps (or speculative verifies) into one CUDA graph and replays it:

- A step works on static tensors (`qwen2.DecodeState`, `speculative.
  SpecState`): the token, the position, `done`, a step counter on the
  device, the chunk's output and the cache, all updated in place. It reads
  nothing back to the host, and it keeps JAX's exit exactly: once the loop
  would have left (every row done, or the counter at `max_steps`), a step
  attends with q_valid 0 for every row, writes nothing into the cache and
  emits eos, so the graph may run whole chunks past the exit.
- The caller reads the host once a chunk (the chunk's tokens, `done`, the
  counter and the lengths, in one copy) and stops after the chunk in which
  the loop left, as the JAX runtime reads once a chunk.
- Graphs are keyed by what they were captured over: the rows, the buffer's
  length, the KV dtype, the weights (the kind and every leaf's address),
  the chunk, sampling and temperature, the draft length and the bound of an
  int8 cache's dequantized prefix, plus the addresses of the cache buffers.
  A cache whose buffers change (the serving runtime's `_recover_cache`)
  drops the graphs over the old ones and is captured again. All graphs of a
  program share one memory pool.
- The first capture of a key runs one step eagerly first, on a state set to
  the loop's exit (so it changes nothing), which makes B4's workspace and
  warms the libraries. That step's launches count as any eager launch
  does; a call under capture counts nothing (`ops._build.count_launch`),
  and each replay launches what its graph's own nodes list: at capture
  the graph's kernel nodes are read back by name (`utils.cuda_graph.
  kernel_counts`), and every replay adds them to `replayed_kernels`
  (`replayed_launches(fn)`: a kernel wrapper's launches made by replays).
- Sampling draws from a generator the program registers with its graphs
  (`CUDAGraph.register_generator_state`); the caller's generator state is
  copied in before the replays and back after, so the draws are those of
  the same `torch.multinomial` calls run eagerly.
- Memory: the graphs' pool, and at most MAX_OWNED caches of the program's
  own (`owned_cache`, `owned_copy`: at full width an 8192-slot bf16 row is
  ~470 MB); a new one past that drops the oldest and the graphs over it.
  `release(cache)` drops the graphs over a cache its owner replaces.
- A program is one set of static buffers: `lock` serializes the decodes
  that use it (`decode_text`, `decode_text_spec` and `chat_batch` hold it).
- A capture or a replay that fails raises; nothing falls back to the eager
  loop. On CPU tensors, or with `graph=False`, the same step function runs
  eagerly, chunk by chunk, with the same one read a chunk.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Optional

import torch

MAX_ENTRIES = 8  # graphs (with their states) a program keeps
MAX_OWNED = 2  # caches of its own a program keeps

# kernel launches made by replays of every program's graphs, by kernel name
replayed_kernels: collections.Counter = collections.Counter()


def _wrapper_kernels() -> dict:
    """Each counted kernel wrapper's kernel: a piece of the mangled name of
    the one kernel that every launch of the wrapper runs once."""
    from bagel_tpu_torch.ops import flash, int4_matmul, int8_matmul, layer_elementwise, sparse_flash

    return {
        flash.flash_cached_attention: ("25flash_decode_split_kernelI13__nv_bfloat16",
                                       "29flash_cached_attention_kernel"),  # T = 1; T > 1
        flash.flash_decode_kv8: ("25flash_decode_split_kernelIa",),
        flash.flash_cached_attention_q8: ("15flash_q8_kernel",),
        flash.q8_prep: ("16q8_absmax_kernel",),
        int4_matmul.int4_matmul: ("18int4_matmul_kernel",),
        int8_matmul.int8_matmul: ("18int8_matmul_kernel",),  # both instances
        int8_matmul.int8_matmul_f32: ("18int8_matmul_kernelIf",),
        int8_matmul.quantize_rows: ("20quantize_rows_kernel",),
        int8_matmul.quantize_rows_given: ("26quantize_rows_given_kernel",),
        int8_matmul.row_absmax: ("17row_absmax_kernel",),
        sparse_flash.sparse_packed_attention: ("30sparse_packed_attention_kernel",),
        sparse_flash.sparse_packed_attention_bwd: ("22sparse_bwd_dkdv_kernel",),
        layer_elementwise.add_rms_norm: ("19add_rms_norm_kernel",),
        layer_elementwise.qk_norm_rope: ("19qk_norm_rope_kernel",),
        layer_elementwise.silu_mul: ("15silu_mul_kernel",),
    }


def replayed_launches(fn) -> int:
    """The launches of kernel wrapper fn's kernel that replays made since
    `replayed_kernels` was last cleared, as the graphs' nodes list them."""
    pieces = _wrapper_kernels()[fn]
    return sum(n for name, n in replayed_kernels.items() if any(p in name for p in pieces))


def weights_key(params: dict) -> tuple:
    """The weights a graph reads: their kind and every leaf's address."""
    kinds, ptrs = set(), []

    def walk(node):
        if isinstance(node, dict):
            kinds.update(k for k in ("w_q8", "w_p4", "w_q", "w_nf4") if k in node)
            for key in sorted(node):
                walk(node[key])
        else:
            ptrs.append(node.data_ptr())

    walk(params)
    return (",".join(sorted(kinds)) or str(params["embed"].dtype), tuple(ptrs))


def buffers_key(cache) -> tuple:
    return tuple(None if t is None else t.data_ptr() for t in cache.buffers())


@dataclasses.dataclass
class _Entry:
    state: Any
    step: Callable  # step(i, generator): the i-th step of a chunk
    n: int  # steps a chunk
    buffers: tuple
    graph: Optional["torch.cuda.CUDAGraph"] = None
    gen: Optional[torch.Generator] = None  # the generator the graph's draws read
    kernels: collections.Counter = dataclasses.field(default_factory=collections.Counter)


class DecodeProgram:
    """Captured decode chunks over static tensors (module docstring).

    `chunk`: steps a graph of `qwen2.decode_text`; `spec_chunk`: verifies a
    graph of `decode_text_spec` (a verify past the exit costs a whole K + 1
    forward, so its chunks are shorter). At most MAX_ENTRIES graphs and
    their states are kept, the least recently used dropped first; the
    caller holds `lock` while it fills a state, runs it and reads it.

    Counts for the record: `captures`, `capture_s` (seconds in capture and
    its warm-up step) and `replays`; `pool_bytes()` is the memory the
    graphs' pool holds."""

    def __init__(self, chunk: int = 16, spec_chunk: int = 4):
        if chunk < 1 or spec_chunk < 1:
            raise ValueError(f"chunks must be positive, got {chunk}, {spec_chunk}")
        self.chunk = chunk
        self.spec_chunk = spec_chunk
        self._entries: "collections.OrderedDict[tuple, _Entry]" = collections.OrderedDict()
        self._owned: "collections.OrderedDict[tuple, Any]" = collections.OrderedDict()
        self.lock = threading.RLock()
        self._pool = None
        self._stream = None
        self._gens: dict = {}
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def pool_bytes(self) -> int:
        """Bytes of the device memory segments the graphs' pool holds."""
        if self._pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self._pool))

    def owned_cache(self, cfg, rows: int, max_len: int, dtype, device, layout=None):
        """The program's own cache of these shapes, its lengths 0 (what it
        held before is dead): a caller that fills a cache and then decodes
        in it (`chat_batch`, holding `lock` from here to its decode) takes
        it here, so its graphs stay valid from call to call. `layout`:
        this process's KV heads (`qwen2.kv_cache_init`)."""
        from bagel_tpu_torch.models.qwen2 import kv_cache_init

        key = (rows, max_len, dtype, torch.device(device))
        own = self._owned_get(key, lambda: kv_cache_init(cfg, rows, max_len, dtype,
                                                         device=device, layout=layout))
        own.length.zero_()
        return own

    def owned_copy(self, cache):
        """The program's own buffers of `cache`'s shapes, holding a copy of
        it: a decode that may not write into the given cache writes here,
        at addresses that stay fixed from call to call."""
        from bagel_tpu_torch.models.qwen2 import KVCache

        def make():
            k, v, ks, vs = (None if t is None else torch.empty_like(t) for t in cache.buffers())
            return KVCache(k=k, v=v, length=cache.length.clone(), k_scale=ks, v_scale=vs)

        key = tuple(None if t is None else (tuple(t.shape), t.dtype, t.device)
                    for t in cache.buffers())
        own = self._owned_get(key, make)
        for dst, src in zip(own.buffers(), cache.buffers()):
            if dst is not None:
                dst.copy_(src)
        own.length.copy_(cache.length)
        return own

    def _owned_get(self, key, make):
        """The owned cache of `key`, made if new; past MAX_OWNED the least
        recently used one goes, with the graphs over it."""
        own = self._owned.get(key)
        if own is None:
            while len(self._owned) >= MAX_OWNED:
                self.release(self._owned.popitem(last=False)[1])
            own = self._owned[key] = make()
        self._owned.move_to_end(key)
        return own

    def release(self, cache) -> None:
        """Drop the graphs and states over `cache`'s buffers (a cache its
        owner replaces or frees: the serving runtime's `_recover_cache`)."""
        dead = buffers_key(cache)
        for key in [k for k, e in self._entries.items() if e.buffers == dead]:
            del self._entries[key]

    def entry(self, key: tuple, buffers: tuple, make_state: Callable, make_step: Callable,
              dead: Callable, *, n: int, graph: bool, sampling: bool) -> _Entry:
        """The key's static state and step (made at first use; captured then
        when `graph`). `dead(state)` sets the state to the loop's exit."""
        key = key + (graph,)
        e = self._entries.get(key)
        if e is not None and e.buffers != buffers:  # new cache buffers: capture again
            del self._entries[key]
            e = None
        if e is None:
            while len(self._entries) >= MAX_ENTRIES:
                self._entries.popitem(last=False)
            state = make_state()
            e = _Entry(state=state, step=make_step(state), n=n, buffers=buffers)
            if graph:
                e.gen = self._generator(state, sampling)
                self._capture(e, dead)
            self._entries[key] = e
        self._entries.move_to_end(key)
        return e

    def _generator(self, state, sampling: bool):
        """The program's generator on the state's device (sampling graphs read it)."""
        if not sampling:
            return None
        dev = state.tok.device
        gen = self._gens.get(dev)
        if gen is None:
            gen = self._gens[dev] = torch.Generator(device=dev)
        return gen

    def _capture(self, e: _Entry, dead: Callable) -> None:
        """Warm up and capture on the program's own stream, into its pool,
        and read the graph's kernels. (Not `torch.cuda.graph`, which empties
        the allocator's cache before every capture: seconds of cudaFree and
        cudaMalloc on a busy card.)"""
        from bagel_tpu_torch.utils.cuda_graph import kernel_counts

        gen = e.gen
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream()
        dead(e.state)
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept until its nodes are read
        if gen is not None:
            graph.register_generator_state(gen)
        self._stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self._stream):
            e.step(0, gen)  # the warm-up, at the loop's exit
            self._stream.synchronize()
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                for i in range(e.n):
                    e.step(i, gen)
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(self._stream)
        e.kernels = kernel_counts(graph)
        graph.instantiate()
        e.graph = graph
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def run(self, e: _Entry, *, generator: Optional[torch.Generator] = None,
            stats: Optional[dict] = None) -> None:
        """One chunk: the entry's graph replayed, or its steps run eagerly.
        Adds the chunk's steps to stats["forwards"]."""
        if e.graph is None:
            for i in range(e.n):
                e.step(i, generator)
        else:
            if e.gen is not None:  # the caller's draws, through the graph's generator
                if generator is None:
                    generator = torch.cuda.default_generators[e.gen.device.index or 0]
                e.gen.set_state(generator.get_state())
            self._replay(e)
            if e.gen is not None:
                generator.set_state(e.gen.get_state())
        if stats is not None:
            stats["forwards"] = stats.get("forwards", 0) + e.n

    def _replay(self, e: _Entry) -> None:
        e.graph.replay()
        replayed_kernels.update(e.kernels)
        self.replays += 1
