"""Megatron tensor parallelism over the mesh's ``model`` group: the
collectives the JAX package's partitioner (GSPMD) inserts around the
column- and row-parallel sites of ``DEFAULT_RULES``, written out.

A rank of the model group holds a slice of the heads and of the MLP's
hidden width (see :mod:`dtc_tpu_torch.parallel.sharding`). Two autograd
functions carry the activations across the sites:

- :func:`copy_to_model` in front of a column-parallel site (q/k/v, fc1,
  the vocab-parallel head): the identity forward (every rank holds the
  replicated input), an all-reduce of the input's gradient backward (each
  rank's slice contributes a part of it);
- :func:`reduce_from_model` behind a row-parallel site (out_proj, fc2): an
  all-reduce of the partial products forward, the identity backward.

The port's choice of rounding: each rank's partial product (or gradient)
is rounded to the compute dtype as its own product is, and the reduction
runs in float32 and rounds its sum once to the compute dtype. A
row-parallel site adds its whole bias once, after the reduction.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class TensorParallel:
    """This rank's place in its model group: ``ranks`` the group's global
    ranks in axis order, ``group`` their process group. ``index`` is this
    rank's position, ``size`` the group's."""

    def __init__(self, ranks, group):
        self.ranks = tuple(ranks)
        self.group = group
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank())

    def part(self, n: int, what: str) -> int:
        """A rank's share of ``n`` columns (``what`` names them in the error
        when they do not divide by the group)."""
        if n % self.size:
            raise ValueError(f"{what} = {n} does not divide by the model axis {self.size}")
        return n // self.size


def all_reduce_sum(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum of ``x`` over the model group, summed in float32 and rounded
    once to x's dtype."""
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device).copy_(x)
    dist.all_reduce(y, group=tp.group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce_sum(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the model group. The
    identity without a model group."""
    return x if tp is None else _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    """The sum of the partial products ``x`` over the model group; the
    gradient passes unchanged. The identity without a model group."""
    return x if tp is None else _ReduceFromModel.apply(x, tp)
