"""Continuous-batching serving runtime (port of bagel_tpu/serving/runtime.py).

The runtime keeps one slot-batched KV cache `[L, slots, max_kv, KH, D]` (of
the engine's `kv_dtype`: int8 with `kv_quant`) and a scheduler thread that
- admits queued chat (understanding) requests into free slots: a batched
  prefill with per-row `valid` writes each new conversation into its own
  cache rows while the other rows keep their live sessions (the ragged
  machinery of `BagelEngine.chat_batch`);
- decodes every active slot together in chunks of `decode_chunk` steps
  (`decode_text(active=...)`, or `decode_text_spec` with `speculative=K`),
  each through the runtime's `DecodeProgram` (JAX's `_decode_chunk_jit` /
  `_decode_spec_chunk_jit`): CUDA-graph replays over the slot cache;
- retires rows that emit eos or exhaust their budget and refills the slots
  from the queue;
- runs image-generation jobs (text-to-image, edit; `generate_batch` for up
  to `gen_batch` jobs of one `gen_batch_key`) between decode chunks.

The slot cache belongs to the runtime, so every prefill and decode chunk
writes into it in place (JAX donates it to its jitted calls). All CUDA work
runs on the scheduler thread; client threads only enqueue and wait on a
`Future`. A failed decode chunk fails every live session and rebuilds the
cache, so the thread keeps serving (`_recover_cache`).

Over a mesh (`mesh=`, the engine's: `BagelEngine(layout=)`) the slot cache
is sharded by JAX's rule (bagel_tpu/serving/runtime.py:150-223): each
process holds its KV heads, and where dp divides the slots each dp
coordinate holds its share of the rows, prefills and decodes only those,
and all-gathers the chunk's tokens and the rows' lengths over dp, so that
every process's scheduler sees the same tick.

Usage:
    rt = ServingRuntime(engine, slots=4, decode_chunk=16)
    rt.start()
    fut = rt.submit_chat("what is in this image?", image=arr)
    ans = fut.result()
    img = rt.submit_generate("a red bicycle", image_shapes=(512, 512)).result()
    rt.stop()
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from bagel_tpu_torch.inference.decode_program import DecodeProgram
from bagel_tpu_torch.inference.engine import _bucket, gen_batch_key
from bagel_tpu_torch.inference.speculative import decode_text_spec
from bagel_tpu_torch.models import qwen2
from bagel_tpu_torch.models.qwen2 import KVCache, kv_cache_init
from bagel_tpu_torch.parallel.mesh import gather_plain
from bagel_tpu_torch.utils import trace


class Future:
    """Minimal blocking future."""

    def __init__(self):
        self._evt = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def set_result(self, value):
        self._result = value
        self._evt.set()

    def set_error(self, err: BaseException):
        self._error = err
        self._evt.set()

    def done(self) -> bool:
        return self._evt.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._evt.wait(timeout):
            raise TimeoutError("request not finished")
        if self._error is not None:
            raise self._error
        return self._result


class _Defer(Exception):
    """Admission must wait for capacity (live sessions too near max_kv)."""


@dataclasses.dataclass
class _ChatRequest:
    prompt: str
    image: Optional[np.ndarray]
    max_new_tokens: int
    future: Future
    # streaming hook: called on the scheduler thread with the token ids of
    # each decode chunk. Keep it fast: it blocks the decode loop.
    on_tokens: Optional[Callable[[List[int]], None]] = None
    # when it was queued (time.perf_counter()): the start of its queue wait
    t_submit: float = dataclasses.field(default_factory=time.perf_counter)


@dataclasses.dataclass
class _GenRequest:
    kwargs: dict
    future: Future


@dataclasses.dataclass
class _Slot:
    req: _ChatRequest
    next_token: int  # decode input token of the next chunk
    next_pos: int  # its rope position
    produced: List[int] = dataclasses.field(default_factory=list)


class ServingRuntime:
    def __init__(
        self,
        engine,
        slots: int = 4,
        decode_chunk: int = 16,
        max_new_default: int = 256,
        mesh=None,
        speculative: int = 0,
        ngram: int = 3,
        gen_batch: int = 1,
        graph: bool = True,
    ):
        """`engine`: a `BagelEngine`; the slot cache lives on its device.
        speculative=K: prompt-lookup speculative decode in every chunk (each
        slot's token history is its lookup corpus; greedy-exact, so the
        served text is unchanged). gen_batch=B: up to B queued text-to-image
        jobs of one `gen_batch_key` run as one `generate_batch`.

        `stats` counts: chat_done, gen_done, chunks, tokens_out (tokens
        delivered), vit_passes (packed SigLIP passes: one per admission
        that carries images), prefill_blocks (the batched extends of
        admissions: one per image round, one for the text) and
        decode_forwards (decoder forwards of the decode chunks: a step of
        one token a row, or a speculative verify of K + 1, past the chunk's
        exit included: the program runs whole chunks), admitted (chat
        requests whose admission's prefill started), queue_wait_s (the
        seconds from `submit_chat` to that start, summed over them) and
        requeued (put-backs into the chat queue of a request that must wait
        for capacity: a group it would not fit under max_kv, or a live row
        too near max_kv for the group's blocks).

        Under a profiler session the scheduler records spans
        (`utils.trace`): runtime.admit (all of `_admit`), within it
        runtime.prefill (the admission's writes, with device time),
        runtime.decode (a chunk's launch to its tokens on the host; device
        time around the launch) and runtime.deliver (the tokens handed to
        the clients, rows retired).

        Each decode chunk runs through the runtime's own `DecodeProgram`
        (`self.decode`: one CUDA-graph replay over the slot cache, captured
        again when `_recover_cache` replaces the cache); graph=False runs
        the same steps eagerly (to compare against).

        `mesh`: the engine's mesh (`engine.mesh`), over which the slot
        cache is sharded (module docstring); every process of the mesh
        runs the same ticks (`serving.multihost`)."""
        if mesh is not None and mesh is not engine.mesh:
            raise ValueError("the slot cache shards over the engine's own mesh: pass "
                             "engine.mesh, from BagelEngine(layout=)")
        self.engine = engine
        self.slots = slots
        self.decode_chunk = decode_chunk
        self.max_new_default = max_new_default
        self.speculative = speculative
        self.ngram = ngram
        self.gen_batch = gen_batch
        self.graph = graph
        self.decode = DecodeProgram(chunk=decode_chunk)
        layout = engine.layout
        # this process's slot rows [first, first + count) and the group that
        # gathers every row's tokens and lengths (None: every row is here)
        self.first, self.count = (0, slots) if layout is None else layout.slot_rows(slots)
        self._dp = None if layout is None else layout.dp_group(slots)
        self.hist = np.zeros((slots, engine.max_kv), np.int64)
        self.hist_len = np.zeros(slots, np.int64)
        self.cache: KVCache = self._new_cache()
        self.slot_state: List[Optional[_Slot]] = [None] * slots
        self.chat_q: "queue.Queue[_ChatRequest]" = queue.Queue()
        self.gen_q: "queue.Queue[_GenRequest]" = queue.Queue()
        # drained but not yet scheduled gen jobs (the scheduler thread's own)
        self._gen_pending: "collections.deque[_GenRequest]" = collections.deque()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"chat_done": 0, "gen_done": 0, "chunks": 0, "tokens_out": 0,
                      "vit_passes": 0, "prefill_blocks": 0, "decode_forwards": 0,
                      "admitted": 0, "queue_wait_s": 0.0, "requeued": 0}

    def _new_cache(self) -> KVCache:
        """The one slot-cache constructor (at start and after a failure):
        this process's rows and KV heads."""
        eng = self.engine
        return kv_cache_init(eng.cfg.llm, self.count, eng.max_kv, eng.kv_dtype,
                             device=eng.device, layout=eng.layout)

    def _here(self, rows: List[int]) -> dict:
        """{cache row: slot} of the slots `rows` that this process holds."""
        return {r - self.first: r for r in rows if self.first <= r < self.first + self.count}

    def _every_row(self, x: torch.Tensor) -> torch.Tensor:
        """A per-row tensor of this process's rows -> every slot's (dp's
        all-gather)."""
        return gather_plain(x, 0, self._dp)

    def _lengths(self) -> List[int]:
        return self._every_row(self.cache.length).tolist()

    # -- client API ----------------------------------------------------------

    def submit_chat(
        self, prompt: str, image=None, max_new_tokens: Optional[int] = None,
        on_tokens: Optional[Callable[[List[int]], None]] = None,
    ) -> Future:
        """Queue an understanding request. image: an HWC float array in
        [-1, 1] (already transformed), a list of them, or None."""
        fut = Future()
        self.chat_q.put(_ChatRequest(prompt, image, max_new_tokens or self.max_new_default,
                                     fut, on_tokens))
        self._wake.set()
        return fut

    def submit_generate(self, prompt: Optional[str] = None,
                        image: Optional[np.ndarray] = None, **kwargs) -> Future:
        """Queue a text-to-image or edit job (`BagelEngine.__call__` kwargs)."""
        fut = Future()
        kw = dict(kwargs)
        if prompt is not None:
            kw["text"] = prompt
        if image is not None:
            kw["image"] = image
        self.gen_q.put(_GenRequest(kw, fut))
        self._wake.set()
        return fut

    def start(self):
        if self._thread is not None:
            raise RuntimeError("the runtime is already running")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 30.0):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -- scheduler internals -------------------------------------------------

    def _free_rows(self) -> List[int]:
        return [i for i, s in enumerate(self.slot_state) if s is None]

    def _reset_length(self, rows: List[int]):
        length = self.cache.length.clone()
        length[list(self._here(rows))] = 0
        self.cache = dataclasses.replace(self.cache, length=length)

    def _recover_cache(self, err: BaseException):
        """Fail every live session and rebuild the cache, after a call that
        failed part way through its in-place writes: the live rows' state
        is no longer trusted, and the scheduler thread keeps serving."""
        for i, s in enumerate(self.slot_state):
            if s is not None:
                self.slot_state[i] = None
                if not s.req.future.done():
                    s.req.future.set_error(err)
        self.decode.release(self.cache)
        self.cache = self._new_cache()

    def _retire(self, i: int):
        """Free a slot and zero its cache length (a stale length would count
        against the capacity checks and shift the next admission's
        writes)."""
        self.slot_state[i] = None
        self._reset_length([i])

    @staticmethod
    def _images(req: _ChatRequest) -> list:
        if req.image is None:
            return []
        return [req.image] if isinstance(req.image, np.ndarray) else list(req.image)

    def _request_widths(self, req: _ChatRequest):
        """([image tokens...], text tokens) the prefill writes for a request:
        the same patch and tokenizer arithmetic as `_prefill_rows`."""
        eng = self.engine
        patch = eng.cfg.vit.patch_size
        img_ns = []
        for im in self._images(req):
            crop = eng._crop_to_multiple(im, patch)
            img_ns.append((crop.shape[0] // patch) * (crop.shape[1] // patch))
        return img_ns, len(eng.tokenizer.encode(req.prompt)) + 2

    @staticmethod
    def _plan_blocks(widths):
        """The write plan of a batched admission group. Each image round and
        the text pad to shared buckets, and every extend writes its padded
        block into every row at that row's length (only rows with valid > 0
        advance), so a row needs the high-water mark of length + block over
        all stages. Returns (round_tbs, text_tb, per_row_need, max_tb)."""
        n_rounds = max((len(w[0]) for w in widths), default=0)
        lens = [0] * len(widths)
        need = [0] * len(widths)
        round_tbs = []
        for k in range(n_rounds):
            tb_k = _bucket(max(w[0][k] for w in widths if len(w[0]) > k) + 2)
            round_tbs.append(tb_k)
            for i, w in enumerate(widths):
                need[i] = max(need[i], lens[i] + tb_k)
                if len(w[0]) > k:
                    lens[i] += w[0][k] + 2
        text_tb = _bucket(max(w[1] for w in widths))
        for i, w in enumerate(widths):
            need[i] = max(need[i], lens[i] + text_tb)
        return round_tbs, text_tb, need, max(round_tbs + [text_tb])

    def _group_fits(self, widths, max_kv: int) -> bool:
        return max(self._plan_blocks(widths)[2]) <= max_kv

    def _admit(self):
        """Move queued chat requests into free slots, in one batched
        prefill. A request joins the group only while every member still
        fits its blocks' writes in max_kv under the group's shared padded
        widths; one that cannot fit even alone fails."""
        with trace.span("runtime.admit"):
            self._admit_group()

    def _admit_group(self):
        free = self._free_rows()
        rows, reqs, widths = [], [], []
        while free and not self.chat_q.empty():
            try:
                req = self.chat_q.get_nowait()
            except queue.Empty:
                break
            w = self._request_widths(req)
            if not self._group_fits([w], self.engine.max_kv):
                need = self._plan_blocks([w])[2][0]
                req.future.set_error(ValueError(
                    f"request needs {need} KV tokens but the buffer holds "
                    f"{self.engine.max_kv}; raise max_kv"
                ))
                continue
            if not self._group_fits(widths + [w], self.engine.max_kv):
                self.chat_q.put(req)  # fits alone: admit it with a later group
                self.stats["requeued"] += 1
                break
            rows.append(free.pop(0))
            reqs.append(req)
            widths.append(w)
        if not rows:
            return
        try:
            self._prefill_rows(rows, reqs, widths)
        except _Defer:
            # a live session is too near max_kv for the padded blocks:
            # requeue, and admit once it retires
            for req in reqs:
                self.chat_q.put(req)
            self.stats["requeued"] += len(reqs)
        except Exception as e:  # a bad request must not kill the scheduler
            for r, req in zip(rows, reqs):
                self.slot_state[r] = None
                req.future.set_error(e)

    def _prefill_rows(self, rows: List[int], reqs: List[_ChatRequest],
                      widths: Optional[list] = None):
        eng = self.engine
        # before touching the cache: every extend writes its padded block
        # into every row at that row's length, so a live row too near the
        # end of the buffer defers the admission (llm_extend would raise)
        if widths is None:
            widths = [self._request_widths(r) for r in reqs]
        max_tb = self._plan_blocks(widths)[3]
        lengths = self._lengths()
        live_max = max((lengths[i] for i, s in enumerate(self.slot_state)
                        if s is not None and i not in rows), default=0)
        if live_max + max_tb > eng.max_kv:
            raise _Defer()

        now = time.perf_counter()
        self.stats["admitted"] += len(reqs)
        self.stats["queue_wait_s"] += sum(now - req.t_submit for req in reqs)
        with trace.span("runtime.prefill", eng.device):
            self._reset_length(rows)  # the admitted rows' old KV is dead
            row_images = {i: self._images(req) for i, req in zip(rows, reqs)}
            ids_rows = {i: eng._prompt_ids(req.prompt) for i, req in zip(rows, reqs)}
            here = self._here(rows)  # the stats count the whole admission, on every process
            if here:
                images = {j: row_images[i] for j, i in here.items()}
                rope_here = {j: 0 for j in here}
                vit_emb, per_img = eng._pack_images(images)
                if vit_emb is not None:
                    self.cache = eng._image_rounds(self.cache, list(here), images, vit_emb,
                                                   per_img, rope_here)
                self.cache = eng._text_rows(self.cache,
                                            {j: ids_rows[i] for j, i in here.items()}, rope_here)
        if any(row_images.values()):
            self.stats["vit_passes"] += 1
            self.stats["prefill_blocks"] += max(len(v) for v in row_images.values())
        self.stats["prefill_blocks"] += 1
        rope = {i: len(row_images[i]) for i in rows}  # each image advances a row's rope by one
        for i, req in zip(rows, reqs):
            self.slot_state[i] = _Slot(req=req, next_token=eng.new_token_ids["bos_token_id"],
                                       next_pos=rope[i] + len(ids_rows[i]))
            # speculative decode's lookup corpus: the prompt's ids, then the
            # tokens each chunk consumes
            n = min(len(ids_rows[i]), self.hist.shape[1])
            self.hist[i, :] = 0
            self.hist[i, :n] = ids_rows[i][:n]
            self.hist_len[i] = n

    def _decode_step(self):
        """One decode chunk over all active slots; retire finished rows.
        The launch and the delivery share one frame: split into two calls,
        the scheduler admitted the clients' next requests a chunk later
        more often (a queue wait of 0.21-0.28 s a request against 0.16-0.19 s
        in the chat benchmark on an H100)."""
        eng = self.engine
        b = self.slots
        eos = eng.new_token_ids["eos_token_id"]
        with trace.span("runtime.decode") as sp:
            # a session whose next chunk could overflow its KV rows ends now
            # with what it has; a speculative chunk writes draft_len + 1
            # entries past the consumed length before rolling back
            lengths = self._lengths()
            margin = self.decode_chunk + (self.speculative + 1 if self.speculative > 0 else 0)
            for i, s in enumerate(self.slot_state):
                if s is not None and lengths[i] + margin > eng.max_kv:
                    self.stats["chat_done"] += 1  # counted before the client sees it
                    self._retire(i)
                    s.req.future.set_result(eng.tokenizer.decode(s.produced))

            start = np.full(b, eos, np.int64)
            pos = np.zeros(b, np.int32)
            active = np.zeros(b, bool)
            for i, s in enumerate(self.slot_state):
                if s is not None:
                    start[i], pos[i], active[i] = s.next_token, s.next_pos, True
            if not active.any():
                return
            dev = eng.device
            counted: dict = {}
            here = slice(self.first, self.first + self.count)  # this process's rows
            common = dict(max_steps=self.decode_chunk, eos_id=eos,
                          active=torch.as_tensor(active[here], device=dev),
                          attn_impl=eng.attn_impl, in_place=True, stats=counted,
                          program=self.decode, graph=self.graph, layout=eng.layout)
            start_t = torch.as_tensor(start[here], device=dev)
            pos_t = torch.as_tensor(pos[here], device=dev)
            llm = eng.params["llm"]
            if self.speculative > 0:
                hist = torch.as_tensor(self.hist[here], device=dev)
                hist_len = torch.as_tensor(self.hist_len[here], device=dev)
                sp.device_start(dev)
                toks, self.cache = decode_text_spec(
                    llm, eng.cfg.llm, self.cache, start_t, pos_t, hist, hist_len,
                    draft_len=self.speculative, ngram=self.ngram, **common,
                )
            else:
                sp.device_start(dev)
                toks, self.cache = qwen2.decode_text(llm, eng.cfg.llm, self.cache, start_t,
                                                     pos_t, **common)
            sp.device_stop()
            toks = self._every_row(toks).tolist()
            self.stats["chunks"] += 1
            self.stats["decode_forwards"] += counted.get("forwards", 0)
        with trace.span("runtime.deliver"):
            for i, s in enumerate(self.slot_state):
                if s is None:
                    continue
                row = toks[i]
                hit_eos = eos in row
                new = row[: row.index(eos)] if hit_eos else row
                emitted = new[: s.req.max_new_tokens - len(s.produced)]
                s.produced.extend(emitted)
                self.stats["tokens_out"] += len(emitted)
                if s.req.on_tokens is not None and emitted:
                    try:
                        s.req.on_tokens(emitted)
                    except Exception:  # noqa: BLE001  a broken stream consumer must not stop decode
                        pass
                if hit_eos or len(s.produced) >= s.req.max_new_tokens:
                    self.stats["chat_done"] += 1
                    self._retire(i)
                    s.req.future.set_result(eng.tokenizer.decode(s.produced))
                else:
                    if self.speculative > 0:
                        # consumed this chunk: its start token and every emitted
                        # token but the last, which is the next chunk's start
                        consumed = [int(start[i])] + new[:-1]
                        h = int(self.hist_len[i])
                        m = min(len(consumed), self.hist.shape[1] - h)
                        self.hist[i, h : h + m] = consumed[:m]
                        self.hist_len[i] = h + m
                    s.next_token = new[-1]
                    s.next_pos += self.decode_chunk

    def _run_gen_jobs(self):
        """Run the gen queue's head job, batched with up to gen_batch - 1
        later jobs of its gen_batch_key (one denoise for all); the others
        keep their order in _gen_pending."""
        while True:
            try:
                self._gen_pending.append(self.gen_q.get_nowait())
            except queue.Empty:
                break
        if not self._gen_pending:
            return
        head = self._gen_pending.popleft()
        batch = [head]
        if self.gen_batch > 1:
            key = gen_batch_key(head.kwargs)
            if key is not None:
                kept = collections.deque()
                for r in self._gen_pending:
                    if len(batch) < self.gen_batch and gen_batch_key(r.kwargs) == key:
                        batch.append(r)
                    else:
                        kept.append(r)
                self._gen_pending = kept
        try:
            if len(batch) == 1:
                # a job alone inherits the runtime's speculative setting for
                # its text decodes (think, understanding) unless it set one
                if self.speculative > 0:
                    head.kwargs.setdefault("speculative", self.speculative)
                outs = [self.engine(**head.kwargs)]
            else:
                outs = self.engine.generate_batch([r.kwargs for r in batch])
            for r, out in zip(batch, outs):
                self.stats["gen_done"] += 1  # counted before the client sees it
                r.future.set_result(out)
        except Exception as e:  # noqa: BLE001  one shared denoise: the batch fails together
            for r in batch:
                if not r.future.done():
                    r.future.set_error(e)

    def _tick(self) -> bool:
        """One scheduler iteration: admit, decode one chunk, run at most one
        gen job. Returns whether any device work happened."""
        self._admit()
        busy = any(s is not None for s in self.slot_state)
        if busy:
            try:
                self._decode_step()
            except Exception as e:  # noqa: BLE001  fail the sessions, keep serving
                self._recover_cache(e)
        # fair interleave: at most one gen run (a batch counts as one)
        # between decode chunks
        if self._gen_pending or not self.gen_q.empty():
            self._run_gen_jobs()
            busy = True
        return busy

    def _drain(self):
        """Fail every queued and live request, so that no client waits on a
        stopped runtime."""
        err = RuntimeError("runtime stopped")
        for i, s in enumerate(self.slot_state):
            if s is not None and not s.req.future.done():
                s.req.future.set_error(err)
                self.slot_state[i] = None
        while self._gen_pending:
            self._gen_pending.popleft().future.set_error(err)
        for q in (self.chat_q, self.gen_q):
            while True:
                try:
                    q.get_nowait().future.set_error(err)
                except queue.Empty:
                    break

    def enter_device(self):
        """Make the engine's card the calling thread's current one (a new
        thread starts on the first card): the scheduler's threads call it
        before any device work."""
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)

    def _loop(self):
        self.enter_device()
        while not self._stop.is_set():
            busy = self._tick()
            if not busy and self.chat_q.empty() and not self._gen_pending:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
        self._drain()
