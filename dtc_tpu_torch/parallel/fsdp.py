"""FSDP (ZeRO-3) for the port's ``GPT``: each rank of the data ring keeps
one shard of every parameter that :data:`~dtc_tpu_torch.parallel.sharding.FSDP_RULES`
shards, and the whole of the others (the JAX package's ``parallel: fsdp``).

Two ways to compute with the shards, as in the JAX package:

- ``collectives: xla`` (JAX's GSPMD path): the model reads each parameter
  through :func:`full` where it uses it, one layer at a time; a sharded
  one is all-gathered over the data group by an autograd Function whose
  backward reduce-scatters its gradient (``torch.distributed`` collectives;
  the product that follows is ``torch.matmul``, as JAX leaves it to XLA).
- ``collectives: overlapped`` (``ModelConfig.collectives``, which
  ``Dense`` reads): the dense layers' weights never gather; each
  dense site computes through :func:`~dtc_tpu_torch.ops.overlap_collectives.overlap_dense_matmul`
  on its shard over :func:`overlap_ring` (TPU kernel rows 17-18). The other
  parameters (biases, LayerNorms, embeddings, the head) gather as above.

On a ``(data, model)`` mesh the ring is the data group of this rank's
model index. Under Megatron tensor parallelism (DP×FSDP×TP, the JAX
package's "3d" mode) a rank's shards are cut from its Megatron slices
(``parity.mesh_shards``): the FSDP ring gathers and reduce-scatters a
slice, and the Megatron reductions stay with the model (``copy_to_model``
/ ``reduce_from_model``), outside the ring. Under ring attention the model
axis holds sequence shards (``seq_group``): every gradient and the loss are
averaged over it too, and the dense sites keep the serialized path, as
the JAX package's sequence-parallel rules make them
(``sharding.fsdp_axis``; :func:`overlap_ring` gives no ring).

The gradient a rank ends its backward with is the sum of every data
rank's local-mean gradient, for a sharded parameter (the reduce-scatter
and the ring's dw both sum), and its own local-mean gradient for a whole
one: :meth:`FSDP.reduce_gradients` scales the first by 1/R once and
averages the second over the data ranks.

An :class:`FSDP` is a rank's state; :func:`use_fsdp` puts it in scope for
the model, as ``ring_attention.use_ring`` does a ring. Over an
``InProcessRing`` (R virtual ranks of one device, the tests' and one card's
stand-in) nothing is sharded: the parameters are whole, :func:`full` is the
identity and the overlapped sites run the ring over the virtual ranks.
"""

from __future__ import annotations

import contextlib
import copy

import torch

from dtc_tpu_torch.ops.ring_attention import DistRing
from dtc_tpu_torch.parallel import sharding


class _AllGather(torch.autograd.Function):
    """A shard all-gathered along ``dim`` over ``ring``'s group; the
    backward reduce-scatters (sums) the gradient back to the shard."""

    @staticmethod
    def forward(ctx, shard, dim, ring):
        import torch.distributed as dist

        ctx.dim, ctx.ring = dim, ring
        parts = [torch.empty_like(shard) for _ in range(ring.size)]
        dist.all_gather(parts, shard.contiguous(), group=ring.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        chunks = [c.contiguous() for c in grad.chunk(ctx.ring.size, ctx.dim)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=ctx.ring.group)
        return out, None, None


class FSDP:
    """One rank's FSDP state over ``ring``: a ``DistRing`` over the data
    ranks of this rank's model index (``shard_`` then cuts the model's
    parameters, a tensor-parallel rank's slices among them, to this rank's
    shards) or an ``InProcessRing``. ``seq_group``: the process group of
    the ranks that hold the other sequence shards (ring attention's model
    group of more than one rank), or None."""

    def __init__(self, ring, seq_group=None):
        self.ring = ring
        self.seq_group = seq_group
        self.dims: dict[int, int] = {}        # id(parameter) -> sharded dim

    @property
    def distributed(self) -> bool:
        return isinstance(self.ring, DistRing)

    def shard_(self, model: torch.nn.Module) -> "FSDP":
        """Cut every parameter of ``model`` that FSDP shards to this rank's
        equal shard along its sharded dim, in place, by its index in the
        ring (its data index). Raises where a dim does not divide by the
        ring."""
        from dtc_tpu_torch.parity import fsdp_shards

        if not self.distributed:
            raise ValueError("only a rank of a DistRing holds shards")
        named = dict(model.named_parameters())
        shards = fsdp_shards({n: p.data for n, p in named.items()}, self.ring.ranks[0],
                             self.ring.size)
        for name, p in named.items():
            d = sharding.param_shard_dim(name)
            if d is not None:
                p.data = shards[name]
                self.dims[id(p)] = d
        return self

    def sharded(self, p: torch.Tensor) -> bool:
        return id(p) in self.dims

    def full(self, p: torch.Tensor) -> torch.Tensor:
        """``p`` whole: all-gathered when this rank holds a shard of it."""
        d = self.dims.get(id(p))
        return p if d is None else _AllGather.apply(p, d, self.ring)

    def reduce_gradients(self, params, loss: torch.Tensor) -> torch.Tensor:
        """After the backward: the sharded parameters' gradients scaled by
        1/R, the whole ones' and the loss averaged over the data ranks (one
        all-reduce of a flat buffer); under ring attention every gradient
        and the loss then averaged over ``seq_group`` as well. Returns the
        averaged loss."""
        from dtc_tpu_torch.train.train_step import average_over_ranks

        params = list(params)
        whole = [p for p in params if not self.sharded(p)]
        loss = average_over_ranks(whole, loss, group=self.ring.group)
        if self.seq_group is not None:
            loss = average_over_ranks(params, loss, group=self.seq_group)
        shards = [p.grad for p in params if self.sharded(p)]
        if shards:
            torch._foreach_mul_(shards, 1.0 / self.ring.size)
        return loss

    @torch.no_grad()
    def gathered(self, model: torch.nn.Module) -> torch.nn.Module:
        """A copy of ``model`` with every shard all-gathered over the data
        ranks and no gradients: the whole model (under tensor parallelism
        this rank's whole Megatron slice), equal on every data rank."""
        # the process groups a tensor-parallel model holds are shared, not copied
        memo = {id(m.tp): m.tp for m in model.modules() if getattr(m, "tp", None) is not None}
        full = copy.deepcopy(model, memo)
        for p, q in zip(model.parameters(), full.parameters()):
            q.grad = None
            if self.sharded(p):
                q.data = _AllGather.apply(p.detach(), self.dims[id(p)], self.ring)
        return full


_AMBIENT: list[FSDP] = []


@contextlib.contextmanager
def use_fsdp(state: FSDP | None):
    """Make ``state`` the FSDP state the model computes with inside the
    block (nothing when None)."""
    if state is None:
        yield None
        return
    _AMBIENT.append(state)
    try:
        yield state
    finally:
        _AMBIENT.pop()


def current() -> FSDP | None:
    return _AMBIENT[-1] if _AMBIENT else None


def full(p: torch.Tensor) -> torch.Tensor:
    """``p`` as the model uses it: gathered under an FSDP state that holds
    a shard of it, else ``p`` itself."""
    state = current()
    return p if state is None else state.full(p)


def overlap_ring():
    """The ring a dense site of a ``collectives: overlapped`` model runs
    the overlapped matmul over: the FSDP state's ring when it has more than
    one rank and no sequence shards own the activations, else None (the
    site keeps its plain product)."""
    state = current()
    if state is None or state.ring.size <= 1 or state.seq_group is not None:
        return None
    return state.ring
