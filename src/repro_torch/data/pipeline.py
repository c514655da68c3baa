"""Host-side prefetching data pipeline (port of `repro.data.pipeline`).

The paper's §4.2 finding, that prefetching is *necessary* for HPC
workloads on tiered memory, shows up here as an input pipeline that keeps
`depth` batches in flight on a background thread so that the host to
device transfer overlaps the previous step's compute (`to_device`: pinned
host memory, copied non-blocking).

Also the straggler-mitigation hook: `skip_to(step)` lets a restarted or
rejoining worker jump the stream forward without replaying work.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import torch


def to_device(device) -> Callable[[dict], dict]:
    """A `transfer` that moves a batch's tensors to `device`: on a CUDA
    device through pinned host memory, non-blocking; identity elsewhere."""
    device = torch.device(device)

    def transfer(batch: dict) -> dict:
        if device.type != "cuda":
            return {k: torch.as_tensor(v).to(device) for k, v in
                    batch.items()}
        return {k: torch.as_tensor(v).pin_memory().to(device,
                                                      non_blocking=True)
                for k, v in batch.items()}

    return transfer


class PrefetchPipeline:
    def __init__(self, batch_fn: Callable[[int], dict], start_step: int = 0,
                 depth: int = 2, transfer: Optional[Callable] = None):
        self._batch_fn = batch_fn
        self._transfer = transfer or (lambda x: x)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._next = start_step
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        while not self._stop.is_set():
            with self._lock:
                step = self._next
                self._next += 1
            try:
                item = (step, self._transfer(self._batch_fn(step)))
            except Exception as e:  # surface in consumer
                item = (step, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self) -> tuple[int, dict]:
        step, item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return step, item

    def skip_to(self, step: int):
        """Fast-forward (drain queue + reset producer): straggler
        catch-up."""
        with self._lock:
            self._next = step
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
