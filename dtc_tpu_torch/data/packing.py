"""Token-stream packing with a resumable position: the port's copy of the
JAX package's ``data/packing.py``.

Documents are concatenated into one flat buffer with no separator tokens
or boundary masking and cut into dense ``(batch, seq_len)`` int32 arrays
in stream order. :meth:`TokenPacker.position` (documents consumed, the
leftover buffer) determines the rest of the stream, so a resumed run
seeks the source and restores the buffer instead of re-reading
everything it consumed.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np


class TokenPacker:
    """Iterator of packed ``(batch_size, seq_len)`` int32 batches over
    ``token_chunks`` (one token list per document), starting from
    ``docs_consumed`` documents already read and ``buffer`` leftover
    tokens."""

    def __init__(
        self,
        token_chunks: Iterable[list[int] | np.ndarray],
        batch_size: int,
        seq_len: int,
        *,
        docs_consumed: int = 0,
        buffer: list[int] | np.ndarray | None = None,
    ):
        self._chunks = iter(token_chunks)
        self._need = batch_size * seq_len
        self._shape = (batch_size, seq_len)
        self.docs_consumed = docs_consumed
        self._buffer = np.asarray(buffer if buffer is not None else [], dtype=np.int32)

    def __iter__(self) -> "TokenPacker":
        return self

    def __next__(self) -> np.ndarray:
        while self._buffer.size < self._need:
            chunk = np.asarray(next(self._chunks), dtype=np.int32)
            self.docs_consumed += 1
            self._buffer = np.concatenate([self._buffer, chunk]) if self._buffer.size else chunk
        batch = self._buffer[: self._need].reshape(self._shape)
        self._buffer = self._buffer[self._need:]
        return batch

    def position(self) -> dict:
        """JSON-serializable resume point: a packer over the same documents
        with ``docs_consumed`` of them skipped and this buffer yields the
        same remaining batches."""
        return {"docs_consumed": int(self.docs_consumed), "buffer": self._buffer.tolist()}
