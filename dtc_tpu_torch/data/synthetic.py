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
