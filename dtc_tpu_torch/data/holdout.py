"""Held-out eval split of a streamed dataset: the port's copy of the JAX
package's ``data/holdout.py``.

Every ``every``-th packed batch from the head of the training stream goes
to the eval set (over the first ``(count-1)*every + 1`` batches) and
training never sees it. :func:`stream_index_for` maps a batch training
consumed to its index in the source stream, so a checkpoint records the
position of what training consumed.
"""

from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np


def diverted_indices(every: int, count: int) -> set[int]:
    """0-based stream indices routed to the eval set."""
    return {k * every for k in range(count)}


def divert_holdout(it: Iterator[np.ndarray], every: int, count: int
                   ) -> tuple[Iterator[np.ndarray], list[np.ndarray]]:
    """Split ``it`` into (training iterator, eval set). Consumes the first
    ``(count-1)*every + 1`` batches at once: indices ``{0, every, ...}``
    become the eval set, the rest are replayed to training before the
    live stream continues."""
    if count <= 0:
        return it, []
    div = diverted_indices(every, count)
    eval_set: list[np.ndarray] = []
    buffered: list[np.ndarray] = []
    for i in range((count - 1) * every + 1):
        batch = next(it)
        (eval_set if i in div else buffered).append(batch)
    return itertools.chain(buffered, it), eval_set


def stream_index_for(train_index: int, withheld: set[int]) -> int:
    """1-based source-stream index of the ``train_index``-th (1-based)
    batch delivered to training when the 0-based source indices in
    ``withheld`` are diverted or dropped."""
    if not withheld:
        return train_index
    seen = 0
    for s in itertools.count():
        if s in withheld:
            continue
        seen += 1
        if seen == train_index:
            return s + 1
    raise AssertionError("unreachable")


def holdout_stream_index(train_index: int, every: int, count: int) -> int:
    """:func:`stream_index_for` under a :func:`divert_holdout` split."""
    return stream_index_for(train_index, diverted_indices(every, count))
