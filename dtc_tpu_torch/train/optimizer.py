"""Global-norm gradient clipping chained into AdamW, written out by hand to
match optax's ``chain(clip_by_global_norm, adamw)`` (the JAX package's
``train/optimizer.py``):

- clip: with ``norm`` the global L2 norm over every gradient, each g
  becomes ``g · (max_norm / norm)`` when ``norm >= max_norm`` and stays as
  it is otherwise (``torch.nn.utils.clip_grad_norm_`` scales by
  ``max_norm / (norm + 1e-6)`` always instead);
- AdamW: ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``, bias
  correction with the incremented count, ``u = mu_hat / (sqrt(nu_hat) +
  1e-8) + weight_decay·p`` on every parameter, ``p -= lr·u``;
- the learning rate is the schedule at the count BEFORE the increment, so
  the first update uses ``lr(0)``: constant, or optax's
  ``warmup_cosine_decay_schedule(0, lr, warmup_steps, total_steps,
  lr·min_lr_ratio)``.

Parameters and moments are updated in place (the JAX package's donated
train state does the same work functionally).

Under FSDP (``fsdp``, a :class:`~dtc_tpu_torch.parallel.fsdp.FSDP` state
over a ``DistRing``) a rank holds shards of the sharded parameters and
whole copies of the rest: the clip's global norm sums the sharded
gradients' squared norms over the data group and counts the whole ones
once. AdamW is elementwise and runs on the shards as they are.

Under Megatron tensor and pipeline parallelism (``norm_groups``, a
:class:`NormGroups`) a rank holds its slices of the tensor-parallel
parameters, whole copies of the rest, and only its stage's parameters: the
clip's global norm sums the squared norms of the sharded gradients over
the model group, counts the replicated ones once, and sums each stage's
total over the pipe group (``optax.clip_by_global_norm`` over the whole
tree of the one-process model). Under both FSDP and tensor parallelism
(DP×FSDP×TP) a squared norm sums over the data group where the parameter
is an FSDP shard and then over the model group where it is a Megatron
slice: a parameter that is both sums over both, and one replicated on an
axis counts once on it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from dtc_tpu_torch.config.schema import OptimConfig

ADAM_EPS = 1e-8


def lr_schedule(cfg: OptimConfig, total_steps: int):
    """``count -> learning rate`` for the configured schedule."""
    if cfg.schedule == "constant":
        return lambda count: cfg.lr
    if total_steps <= 0:
        raise ValueError("warmup_cosine schedule needs total_steps > 0")
    warm = cfg.warmup_steps
    decay = total_steps - warm
    if decay <= 0:
        raise ValueError("warmup_cosine needs total_steps > warmup_steps")
    alpha = cfg.min_lr_ratio  # end_value / peak_value

    def lr(count: int) -> float:
        if count < warm:
            return cfg.lr * count / warm
        c = min(count - warm, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return cfg.lr * ((1.0 - alpha) * cosine + alpha)

    return lr


@dataclass
class NormGroups:
    """Where the parameters of a tensor- and pipeline-parallel rank lie:
    ``sharded`` per parameter (in the optimizer's order), whether it is a
    tensor-parallel slice; ``model`` / ``pipe`` the process groups the
    squared norms sum over (None for an axis of one rank)."""

    sharded: list[bool]
    model: object = None
    pipe: object = None


class ClippedAdamW:
    """Clip by global norm, then AdamW, over ``params`` (their ``.grad``)."""

    def __init__(self, params, cfg: OptimConfig, total_steps: int = 0, fsdp=None,
                 norm_groups: NormGroups | None = None):
        if cfg.precision != "fp32":
            raise NotImplementedError(
                "precision: bf16_mixed (fp32 master weights) is not ported "
                "yet; it is queued after the training slice"
            )
        self.params = [p for p in params if p.requires_grad]
        self.cfg = cfg
        self.fsdp = fsdp if fsdp is not None and fsdp.distributed else None
        self._sharded = (None if self.fsdp is None else
                         [self.fsdp.sharded(p) for p in self.params])
        self.norm_groups = norm_groups
        if norm_groups is not None and len(norm_groups.sharded) != len(self.params):
            raise ValueError("norm_groups.sharded needs one flag per parameter")
        self.lr = lr_schedule(cfg, total_steps)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad``. Multi-tensor
        (``torch._foreach_*``) ops keep the launches per step independent of
        the number of parameters; nothing here syncs with the device."""
        cfg = self.cfg
        grads = [p.grad for p in self.params]
        if any(g is None for g in grads):
            raise RuntimeError("every parameter needs a gradient before step()")
        if cfg.grad_clip > 0:
            norm = torch.linalg.vector_norm(self._param_norms(grads))
            factor = torch.where(norm < cfg.grad_clip, 1.0, cfg.grad_clip / norm)
            grads = torch._foreach_mul(grads, factor)
        lr = self.lr(self.count)
        self.count += 1
        b1, b2 = cfg.b1, cfg.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        den = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        upd = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        torch._foreach_div_(upd, den)
        if cfg.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=cfg.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)

    def _param_norms(self, grads) -> torch.Tensor:
        """Each parameter's gradient norm; under FSDP a sharded one's is the
        norm over every rank's shard (the squares summed over the data
        group; at one rank ``sqrt(x²)`` gives x back, so the single-process
        bits). Under ``norm_groups`` one norm: the whole model's."""
        norms = torch.stack(torch._foreach_norm(grads))
        import torch.distributed as dist

        sq = norms * norms
        if self.fsdp is not None:
            # FSDP shards (of a Megatron slice or of a replicated
            # parameter): their squares summed over the data group
            mask = torch.tensor(self._sharded, device=norms.device)
            part = torch.where(mask, sq, torch.zeros_like(sq))
            dist.all_reduce(part, group=self.fsdp.ring.group)
            sq = torch.where(mask, part, sq)
        ng = self.norm_groups
        if ng is None:
            return norms if self.fsdp is None else torch.where(mask, torch.sqrt(sq), norms)
        mask = torch.tensor(ng.sharded, device=norms.device)
        sharded = torch.where(mask, sq, torch.zeros_like(sq)).sum().reshape(1)
        if ng.model is not None:
            dist.all_reduce(sharded, group=ng.model)
        total = sharded + torch.where(mask, torch.zeros_like(sq), sq).sum()
        if ng.pipe is not None:
            dist.all_reduce(total, group=ng.pipe)
        return torch.sqrt(total)


def create_optimizer(params, cfg: OptimConfig, total_steps: int = 0,
                     fsdp=None, norm_groups: NormGroups | None = None) -> ClippedAdamW:
    return ClippedAdamW(params, cfg, total_steps, fsdp, norm_groups)
