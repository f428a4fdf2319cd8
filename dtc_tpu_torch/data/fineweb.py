"""The resumable FineWeb-Edu batch stream: the port's copy of the JAX
package's ``data/fineweb.py``.

Documents come from HuggingFace streaming of ``HuggingFaceFW/fineweb-edu``
(``datasets`` is imported only when the stream opens), are tokenized one
by one and packed by :class:`~dtc_tpu_torch.data.packing.TokenPacker`.
Several processes see disjoint stripes of the documents
(:func:`stride_documents`). :class:`FinewebStream` keeps the position
after each batch it yielded, which a checkpoint records; a stream built
from such a position skips the documents already read at the source and
restores the packer's buffer, so it continues batch for batch. The source
is wrapped in :func:`~dtc_tpu_torch.resilience.retry.resilient_iterator`,
which re-opens it at the failing document after a transient fault and
posts a ``stream_retry`` record to ``on_recovery``; a chaos injector's
document hook sits inside the wrapper, so its injected fault heals on the
production path.

``documents=`` takes pre-tokenized documents instead of the network
source (tests, offline runs); given as a sequence it can be re-opened
too, so the retry path runs offline.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Iterable, Iterator

import numpy as np

from dtc_tpu_torch.data.packing import TokenPacker
from dtc_tpu_torch.data.tokenizer import get_tokenizer


def stride_documents(documents: Iterable, process_index: int, process_count: int,
                     start_index: int = 0) -> Iterator:
    """Round-robin stripe of a document stream: process p sees the items
    whose absolute index is p mod N. ``start_index`` is the absolute index
    of the first item of ``documents`` (nonzero after a skip), so the
    stripes stay aligned across resumes."""
    for i, item in enumerate(documents, start=start_index):
        if i % process_count == process_index:
            yield item


def _wrap_resilient(open_at, raw_skip: int, retry=None, chaos=None, on_recovery=None,
                    cancel=None) -> Iterator:
    """The raw document source ``open_at(index)`` (a fresh iterator whose
    first item has absolute index ``index``) from ``raw_skip`` on, with the
    chaos hook inside and the retry wrapper (when ``retry``, a
    ``StreamRetryConfig``, is enabled) outside: one exactly-once document
    sequence across any number of re-opens. ``on_recovery`` receives the
    wrapper's retry records."""
    def factory(index: int) -> Iterator:
        it = open_at(index)
        if chaos is not None:
            it = chaos.wrap_raw_documents(it, index)
        return it

    if retry is None or not getattr(retry, "enabled", True):
        return factory(raw_skip)
    from dtc_tpu_torch.resilience.retry import resilient_iterator

    return resilient_iterator(
        factory, start_index=raw_skip, max_attempts=retry.max_attempts,
        backoff_s=retry.backoff_s, backoff_max_s=retry.backoff_max_s,
        jitter=retry.jitter, max_elapsed_s=getattr(retry, "max_elapsed_s", 0.0),
        on_event=on_recovery, cancel=cancel,
    )


def _document_tokens(tokenizer, process_index: int, process_count: int,
                     raw_skip: int = 0, retry=None, chaos=None, on_recovery=None,
                     cancel=None) -> Iterator[list[int]]:
    """This process's stripe of the network stream, tokenized."""
    def open_at(index: int) -> Iterator:
        from datasets import load_dataset

        ds = load_dataset("HuggingFaceFW/fineweb-edu", split="train", streaming=True)
        if index:
            ds = ds.skip(index)  # seek at the source: consumed documents are not re-read
        return iter(ds)

    raw = _wrap_resilient(open_at, raw_skip, retry, chaos, on_recovery, cancel)
    for item in stride_documents(raw, process_index, process_count, raw_skip):
        yield tokenizer.encode(item["text"])


class FinewebStream:
    """Resumable iterator of ``(batch_size, seq_len)`` int32 batches.

    ``position`` (from an earlier stream's :meth:`position_after`) seeks the
    document source and restores the packer's buffer. The positions after
    the last ``history`` yields are kept, so the position of the batch
    training consumed can be read while prefetch has pulled a few batches
    ahead. ``documents`` injects pre-tokenized raw documents, striped and
    skipped as the network source is. ``chaos`` (a
    :class:`~dtc_tpu_torch.resilience.chaos.ChaosInjector`) threads the
    fault hook into the document source and ``on_recovery`` receives the
    retry records."""

    def __init__(self, batch_size: int, seq_len: int, tokenizer=None, *,
                 process_index: int = 0, process_count: int = 1,
                 documents: Iterable[list[int]] | None = None,
                 position: dict | None = None, history: int = 64,
                 retry=None, chaos=None, on_recovery=None, cancel=None):
        pos = position or {"docs_consumed": 0, "buffer": []}
        skip = int(pos["docs_consumed"])  # striped documents already consumed
        # The k-th striped document of process p is raw index p + k·N: after
        # `skip` of them the next raw index is p + skip·N, so skipping
        # skip·N raw documents keeps every process's stripe aligned.
        raw_skip = skip * process_count
        if documents is not None:
            if hasattr(documents, "__getitem__"):
                # A sequence: a true seek, re-openable by the retry wrapper.
                raw = _wrap_resilient(lambda index: iter(documents[index:]), raw_skip,
                                      retry, chaos, on_recovery, cancel)
            else:
                # A plain iterator cannot be re-opened: no healing.
                raw = itertools.islice(documents, raw_skip, None)
                if chaos is not None:
                    raw = chaos.wrap_raw_documents(raw, raw_skip)
            docs = stride_documents(raw, process_index, process_count, raw_skip)
        else:
            docs = _document_tokens(tokenizer or get_tokenizer(), process_index,
                                    process_count, raw_skip, retry=retry, chaos=chaos,
                                    on_recovery=on_recovery, cancel=cancel)
        self._packer = TokenPacker(docs, batch_size, seq_len, docs_consumed=skip,
                                   buffer=pos["buffer"])
        #: count of batches yielded so far (the last one's 1-based index)
        self.yielded = 0
        self._history: deque[tuple[int, dict]] = deque(maxlen=history)
        # __next__ runs on the prefetch thread, position_after on the
        # trainer's at checkpoint time.
        self._lock = threading.Lock()

    def __iter__(self) -> "FinewebStream":
        return self

    def __next__(self) -> np.ndarray:
        batch = next(self._packer)
        with self._lock:
            self.yielded += 1
            self._history.append((self.yielded, self._packer.position()))
        return batch

    def position_after(self, stream_index: int) -> dict:
        """The resume position after the ``stream_index``-th (1-based)
        yielded batch; ``KeyError`` when it has left the history."""
        with self._lock:
            entries = list(self._history)
        for n, p in entries:
            if n == stream_index:
                return p
        raise KeyError(
            f"position for stream index {stream_index} not in history "
            f"(have {[n for n, _ in entries]}); increase history="
        )
