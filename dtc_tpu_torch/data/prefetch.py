"""Host->device batch feeding with background prefetch.

A worker thread runs the host iterator, splits each ``(B, T+1)`` token
batch into next-token inputs and targets (``x = [:, :-1]``,
``y = [:, 1:]``), pins them, and starts their copy to the device with
``non_blocking=True``, keeping ``depth`` batches in flight. ``depth=0``
feeds synchronously on the caller's thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


def split_to_device(batch: np.ndarray, device: torch.device):
    """``(x, y)`` int64 tensors on ``device`` from a ``(B, T+1)`` batch.
    For a CUDA device the host copies are pinned and the transfers
    asynchronous on the current stream."""
    tokens = torch.from_numpy(np.ascontiguousarray(batch)).long()
    x, y = tokens[:, :-1].contiguous(), tokens[:, 1:].contiguous()
    if device.type != "cuda":
        return x.to(device), y.to(device)
    return (x.pin_memory().to(device, non_blocking=True),
            y.pin_memory().to(device, non_blocking=True))


class PrefetchIterator:
    """Yield ``(x, y)`` device tensors from a host batch iterator. An
    exception in the worker reaches the consumer as the original
    exception; :meth:`close` stops the worker."""

    _POLL_S = 1.0

    def __init__(self, host_iterator: Iterator[np.ndarray], device: torch.device,
                 depth: int = 2):
        self._it = host_iterator
        self._device = device
        self._queue: queue.Queue | None = None
        self._err: BaseException | None = None
        self._done = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if depth > 0:
            self._queue = queue.Queue(maxsize=depth)
            self._thread = threading.Thread(target=self._worker, daemon=True,
                                            name="dtc-torch-prefetch")
            self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        # The copies go on the device's default stream, the one the trainer
        # computes on, so stream order puts each copy before its first use.
        try:
            for batch in self._it:
                if not self._put(split_to_device(batch, self._device)):
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            if not self._stop.is_set():
                self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        if self._queue is None:
            return split_to_device(next(self._it), self._device)
        if self._done:
            raise StopIteration
        while True:
            try:
                item = self._queue.get(timeout=self._POLL_S)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    try:
                        item = self._queue.get_nowait()
                        break
                    except queue.Empty:
                        raise RuntimeError(
                            "prefetch worker died without delivering a batch "
                            "or an error"
                        ) from self._err
        if item is None:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the worker and drop queued batches. Idempotent."""
        self._stop.set()
        if self._queue is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
