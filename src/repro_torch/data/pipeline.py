"""Prefetching, deterministic data pipeline.

Batches are pure functions of the step index (``data/synthetic.py``), so

* resume-exactness: restarting at step k regenerates batch k bit-identically
  (no iterator state in checkpoints);
* sharding: each process materializes only its slice of the global batch
  (``host_slice``);
* straggler tolerance: a worker that falls behind can skip ahead to the
  fleet's step counter without coordination (``skip_ahead``);
* prefetch: a background thread keeps ``depth`` batches ready so host-side
  generation overlaps device compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import torch


class Prefetcher:
    """Background-thread prefetch of an index-driven batch function."""

    def __init__(self, batch_fn: Callable[[int], object], start_step: int = 0,
                 depth: int = 2):
        self._fn = batch_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self._fn(step)
            except Exception as e:  # surface errors on the consumer side
                self._q.put(e)
                return
            # block until there is room (or stop)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def host_slice(global_batch: int, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> slice:
    """The slice of the global batch this process materializes; the index
    and count default to the ``torch.distributed`` group's rank and size,
    or (0, 1) outside one."""
    dist = torch.distributed
    grouped = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if grouped else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if grouped else 1) if process_count is None else process_count
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


def skip_ahead(current_step: int, fleet_step: int, max_skip: int = 1_000_000) -> int:
    """Straggler mitigation: jump a lagging worker to the fleet's step. Pure
    bookkeeping, since batches are index-addressed; ``max_skip`` bounds
    silent divergence."""
    if fleet_step < current_step:
        return current_step
    return min(fleet_step, current_step + max_skip)
