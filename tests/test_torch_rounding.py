"""Where the port rounds in bfloat16: the dense layers and the LM head add
their bias after the product is rounded to the compute dtype, as flax's
``nn.Dense`` and the JAX package's ``head_logits`` do. ``F.linear`` with a
bias rounds once, and differs from them in about 30% of bf16 outputs at
these shapes; the port must equal them bit for bit.

The bit-exact tests draw x and W from a grid of small multiples of powers
of two, so every float32 partial sum of the product is exact and the
summation order (XLA's and PyTorch's differ) cannot move a product across
a bf16 rounding boundary: what is compared is where each package rounds.
On Gaussian inputs the two orders flip a handful of the 32,768 products
by one ulp; that test bounds the flips instead.
"""

import dataclasses

import numpy as np
import pytest

import flax.linen as fnn
import jax.numpy as jnp
import torch

from dtc_tpu.ops.fused_ce import head_logits as jhead_logits
from dtc_tpu_torch.config.schema import ModelConfig
from dtc_tpu_torch.models.gpt import Dense
from dtc_tpu_torch.ops.fused_ce import head_logits

N, D_IN, D_OUT = 64, 512, 512


def _inputs(seed, grid=True):
    """x (N, D_IN), flax kernel w (D_IN, D_OUT), bias b. On the grid, x is
    a multiple of 2^-3 and w of 2^-6, both at most 1 in magnitude, so the
    exact sums need 18 bits and float32 holds every partial sum."""
    rng = np.random.RandomState(seed)
    if grid:
        x = (rng.randint(-8, 9, size=(N, D_IN)) / 8.0).astype(np.float32)
        w = (rng.randint(-64, 65, size=(D_IN, D_OUT)) / 64.0 / 4.0).astype(np.float32)
    else:
        x = rng.randn(N, D_IN).astype(np.float32)
        w = (rng.randn(D_IN, D_OUT) / np.sqrt(D_IN)).astype(np.float32)
    b = rng.randn(D_OUT).astype(np.float32)
    return x, w, b


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _jbits(a) -> np.ndarray:
    return np.asarray(a).view(np.int16)


def _bf16_dense_pair(x, w, b):
    want = fnn.Dense(D_OUT, dtype=jnp.bfloat16, param_dtype=jnp.float32).apply(
        {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}},
        jnp.asarray(x).astype(jnp.bfloat16),
    )
    cfg = ModelConfig(vocab_size=97, d_model=D_IN, n_layers=1, n_heads=8, d_ff=D_OUT,
                      max_seq_len=32, compute_dtype="bfloat16")
    dense = Dense(D_IN, D_OUT, cfg, device="cpu")
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(w.T.copy()))
        dense.bias.copy_(torch.from_numpy(b))
        got = dense(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    return dense, got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_dense_is_bit_equal_to_flax_dense(seed):
    x, w, b = _inputs(seed)
    dense, got, want = _bf16_dense_pair(x, w, b)
    np.testing.assert_array_equal(_bits(got), _jbits(want))
    # What the repair changed: a single rounding of product + bias differs.
    fused = torch.nn.functional.linear(
        torch.from_numpy(x).to(torch.bfloat16), dense.weight.to(torch.bfloat16),
        dense.bias.to(torch.bfloat16),
    )
    assert (_bits(fused) != _jbits(want)).mean() > 0.1


def test_bf16_dense_on_gaussian_inputs_differs_only_by_summation_order():
    """At most 4 of 32,768 outputs (a product's fp32 sum landing on the
    other side of a bf16 rounding boundary in the other order), each by one
    ulp; F.linear's single rounding moved thousands."""
    x, w, b = _inputs(0, grid=False)
    _, got, want = _bf16_dense_pair(x, w, b)
    diff = np.abs(_bits(got).astype(np.int32) - _jbits(want).astype(np.int32))
    assert (diff != 0).sum() <= 4 and diff.max() <= 1


@pytest.mark.parametrize("vocab", [D_OUT, D_OUT - 12])
def test_bf16_head_logits_are_bit_equal_to_jax(vocab):
    x, w, b = _inputs(2)
    want = jhead_logits(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w),
                        jnp.asarray(b), vocab)
    got = head_logits(torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(w.T.copy()), torch.from_numpy(b), vocab)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _jbits(want))


def test_fp32_dense_matches_flax_dense():
    x, w, b = _inputs(3)
    want = fnn.Dense(D_OUT, dtype=jnp.float32).apply(
        {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}, jnp.asarray(x)
    )
    cfg = dataclasses.replace(
        ModelConfig(vocab_size=97, d_model=D_IN, n_layers=1, n_heads=8, d_ff=D_OUT,
                    max_seq_len=32),
        compute_dtype="float32",
    )
    dense = Dense(D_IN, D_OUT, cfg, device="cpu")
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(w.T.copy()))
        dense.bias.copy_(torch.from_numpy(b))
        got = dense(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
