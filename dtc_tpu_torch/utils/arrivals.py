"""Seeded open-loop request material: the port's copy of the JAX package's
``utils/arrivals.py``.

A Poisson arrival schedule and a set of uniform-random prompts, drawn from
one seeded generator so that a seed reproduces a fleet run's traffic bit
for bit. The draw ORDER is part of the contract: arrivals first, then
prompts, from one ``np.random.RandomState(seed)``.
"""

from __future__ import annotations

import numpy as np


def poisson_arrivals(
    rng: np.random.RandomState, n_requests: int, rps: float | None
) -> np.ndarray:
    """Cumulative arrival offsets (seconds from the window's start) of an
    open-loop Poisson process at ``rps`` requests a second; ``rps=None``
    is the closed loop: everything arrives at 0."""
    if rps is None:
        return np.zeros(n_requests)
    return np.cumsum(rng.exponential(1.0 / rps, size=n_requests))


def seeded_prompts(
    rng: np.random.RandomState, n_requests: int, prompt_len: int,
    vocab_size: int,
) -> list[list[int]]:
    """``n_requests`` uniform-random token prompts of ``prompt_len``."""
    return [
        rng.randint(0, vocab_size, size=prompt_len).tolist()
        for _ in range(n_requests)
    ]


def arrival_schedule(
    seed: int, n_requests: int, prompt_len: int, vocab_size: int,
    rps: float | None,
) -> tuple[np.ndarray, list[list[int]]]:
    """``(arrivals, prompts)`` from one generator seeded with ``seed``,
    arrivals drawn first."""
    rng = np.random.RandomState(seed)
    arrivals = poisson_arrivals(rng, n_requests, rps)
    prompts = seeded_prompts(rng, n_requests, prompt_len, vocab_size)
    return arrivals, prompts
