"""Deterministic synthetic token data.

A reproducible, learnable token stream for tests and benchmarks: Zipf-ish
unigrams with short-range copy structure, so the loss falls. Batch ``i``
for a given (seed, shape, vocab) is the JAX package's batch ``i``
(``dtc_tpu/data/synthetic.py``), number for number.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_batch_iterator(
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
    start: int = 0,
) -> Iterator[np.ndarray]:
    """Yield deterministic ``(batch_size, seq_len)`` int32 batches from
    batch ``start`` on (O(1): a resumed run seeks by it)."""
    i = start
    while True:
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        base = rng.zipf(1.3, size=(batch_size, seq_len)).astype(np.int64)
        tokens = (base - 1) % vocab_size
        # Copy structure: each position repeats the token 8 back with p=0.5.
        copy_mask = rng.random((batch_size, seq_len)) < 0.5
        shifted = np.roll(tokens, 8, axis=1)
        tokens = np.where(copy_mask, shifted, tokens)
        yield tokens.astype(np.int32)
        i += 1


def synthetic_row(seq_len: int, vocab_size: int, seed: int, row: int) -> np.ndarray:
    """One deterministic ``(seq_len,)`` row seeded by its row index alone:
    row ``r`` is the same whatever batch holds it (the JAX package's
    ``synthetic_row``, number for number)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1, row]))
    base = rng.zipf(1.3, size=(seq_len,)).astype(np.int64)
    tokens = (base - 1) % vocab_size
    copy_mask = rng.random((seq_len,)) < 0.5
    shifted = np.roll(tokens, 8)
    tokens = np.where(copy_mask, shifted, tokens)
    return tokens.astype(np.int32)


def synthetic_row_batches(
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
    start_row: int = 0,
) -> Iterator[np.ndarray]:
    """Batches of the flat row stream from row ``start_row`` on: a batch of
    ``B`` rows starting at row ``r`` holds rows ``[r, r + B)``. Its token
    count does not depend on the batch shape, so a run whose mesh changes
    re-seeks by rows consumed; elastic training and the pool's trainer
    read it."""
    r = start_row
    while True:
        yield np.stack([synthetic_row(seq_len, vocab_size, seed, r + b)
                        for b in range(batch_size)])
        r += batch_size
