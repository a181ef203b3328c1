"""Prefetching training loaders (port of bagel_tpu/data/loader.py).

The reference feeds the device from torch DataLoader worker subprocesses
(pretrain_unified_navit.py:625-650). `PrefetchLoader` runs the packing
iterator (PIL decode + resize + pack are the CPU cost) on a background
thread; `MultiprocessLoader` runs N packing workers as spawned
subprocesses that never touch the device. Both run the frozen-VAE encode
on the device in the consuming process and hand out batches on the device,
the posterior samples drawn from one torch.Generator.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import torch

from bagel_tpu_torch.configs import BagelConfig
from bagel_tpu_torch.data.packing import HostBatch, encode_vae_images


def _to_device(item: HostBatch, vae_params, cfg: BagelConfig, generator, device):
    if cfg.visual_gen and item.vae_images:
        batch = encode_vae_images(vae_params, cfg, item, generator, device)
    else:
        batch = item.batch.to(device)
    return batch, item.data_indexes


class PrefetchLoader:
    """Wraps a HostBatch iterator with thread prefetch + device VAE encode.

    Yields (PackedTrainBatch on `device` with vae_patches filled,
    data_indexes).
    """

    def __init__(
        self,
        host_iter: Iterator[HostBatch],
        vae_params,
        cfg: BagelConfig,
        generator: torch.Generator,
        device,
        prefetch: int = 2,
    ):
        self.host_iter = host_iter
        self.vae_params = vae_params
        self.cfg = cfg
        self.generator = generator
        self.device = device
        self.queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self._stop = threading.Event()
        self.thread.start()

    def _worker(self):
        try:
            for host in self.host_iter:
                if self._stop.is_set():
                    return
                self.queue.put(host)
        except Exception as e:  # propagate to consumer
            self.queue.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.queue.get()
        if isinstance(item, Exception):
            raise item
        return _to_device(item, self.vae_params, self.cfg, self.generator, self.device)

    def stop(self):
        """End the prefetch thread: the queue is drained until it returns
        (a put blocked on a full queue would keep it, and through it the
        model's VAE weights on the device, alive past the run)."""
        self._stop.set()
        self.vae_params = None
        while self.thread.is_alive():
            try:
                self.queue.get_nowait()
            except queue.Empty:
                pass
            self.thread.join(timeout=0.05)


class _WorkerDone:
    """Queue sentinel: a worker's iterator is exhausted (or it failed)."""


def _mp_worker_main(factory, worker_id: int, num_workers: int, q, stop_evt):
    """Subprocess entry: run one packer shard, push numpy HostBatches.

    The worker never touches the device (the parent owns it); `factory`
    must build its iterator with as_device=False packing and numpy-only
    transforms.
    """
    try:
        for host in factory(worker_id, num_workers):
            if stop_evt.is_set():
                return
            q.put(host)
    except Exception as e:  # surface in the consumer
        try:
            q.put(e)
        except Exception:  # the exception itself may be unpicklable
            q.put(RuntimeError(
                f"packing worker {worker_id} failed: {type(e).__name__}: {e}"
            ))
    finally:
        try:
            q.put(_WorkerDone())
        except Exception:
            pass


class MultiprocessLoader:
    """N packing worker subprocesses feeding the device — the reference's
    DataLoader(num_workers=N) equivalent (pretrain_unified_navit.py:625-650).

    Each worker builds its own dataset shard (rank- then worker-sharded file
    lists, distributed_iterable_dataset.py semantics) and runs the full
    host-side pipeline: IO, PIL decode, resize, tokenize, pack, pad — in
    parallel across cores. The parent process round-robin-consumes from a
    shared queue and runs the frozen-VAE encode on the device.

    `factory(worker_id, num_workers)` -> iterator of HostBatch with numpy
    arrays (packing.finalize(as_device=False)).
    """

    def __init__(
        self,
        factory,
        num_workers: int,
        vae_params,
        cfg: BagelConfig,
        generator: torch.Generator,
        device,
        prefetch_per_worker: int = 2,
        start_method: str = "spawn",
    ):
        import multiprocessing as mp

        assert num_workers >= 1
        # spawn, not fork: the parent holds a live CUDA context and threads
        # whose locks make forked children deadlock-prone. factory must be
        # picklable (a module-level function or functools.partial).
        ctx = mp.get_context(start_method)
        self.cfg = cfg
        self.vae_params = vae_params
        self.generator = generator
        self.device = device
        self.queue = ctx.Queue(maxsize=prefetch_per_worker * num_workers)
        self._stop = ctx.Event()
        self._done = 0  # workers that have enqueued their _WorkerDone
        self.procs = [
            ctx.Process(
                target=_mp_worker_main,
                args=(factory, w, num_workers, self.queue, self._stop),
                daemon=True,
            )
            for w in range(num_workers)
        ]
        for p in self.procs:
            p.start()

    def __iter__(self):
        return self

    def __next__(self):
        import queue as queue_mod

        while True:
            try:
                item = self.queue.get(timeout=5.0)
            except queue_mod.Empty:
                # distinguish "still packing" from "nobody left to produce":
                # a worker killed by the OOM-killer or a segfault in native
                # code never enqueues its sentinel — without this check the
                # training loop would block on get() forever
                if not any(p.is_alive() for p in self.procs):
                    if self._done >= len(self.procs):
                        raise StopIteration
                    raise RuntimeError(
                        "all packing workers died without finishing "
                        "(killed or crashed); check worker memory use"
                    )
                continue
            if isinstance(item, _WorkerDone):
                self._done += 1
                if self._done >= len(self.procs):
                    raise StopIteration
                continue
            if isinstance(item, Exception):
                raise item
            break
        return _to_device(item, self.vae_params, self.cfg, self.generator, self.device)

    def stop(self):
        self._stop.set()
        for p in self.procs:
            p.terminate()
            p.join(timeout=5)
