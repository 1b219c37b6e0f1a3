"""Host-sharded batching with background prefetch (counterpart of
``repro.data.loader``; batches stay numpy, the trainer moves them to its
device).

Each host materializes only its slice of the global batch; a daemon thread
keeps a small queue of ready batches so a slow data step never stalls the
accelerator (the trainer's watchdog flags it instead).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np


class PrefetchLoader:
    def __init__(self, sample_fn: Callable[[int], Dict[str, np.ndarray]],
                 *, depth: int = 2, start_step: int = 0):
        """sample_fn(step) -> host-local batch dict."""
        self.sample_fn = sample_fn
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self.sample_fn(step)
            except Exception:           # pragma: no cover - defensive
                self._stop.set()
                raise
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, batch = self.q.get()
        return step, batch

    def __iter__(self) -> Iterator:
        while True:
            yield next(self)

    def close(self):
        self._stop.set()
        while not self.q.empty():
            try:
                self.q.get_nowait()
            except queue.Empty:
                break


def host_slice(global_batch: int, n_hosts: int, host_id: int) -> slice:
    per = global_batch // n_hosts
    return slice(host_id * per, (host_id + 1) * per)
