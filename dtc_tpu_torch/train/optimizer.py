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

With ``skip_nonfinite`` the update is optax's ``apply_if_finite(chain(clip,
adamw), max_consecutive_errors=max_consecutive_skips)``: a step whose
gradients are not all finite leaves the parameters, the moments and the
count as they were, unless it is the ``max_consecutive_skips + 1``-th such
step in a row, which is applied anyway. The decision is made on the
device from the global norm the clip computes (non-finite exactly when a
gradient is), with ``torch.where``: no host sync. The count then lives
on the device too, and the learning rate is read from a table of the
schedule's values.

:meth:`ClippedAdamW.state_dict` / :meth:`~ClippedAdamW.load_state_dict`
carry the moments, the count (the warmup updates included, as optax's) and
the skip counters into and out of a checkpoint.

Under ``precision: bf16_mixed`` (the JAX package's ``with_master_weights``
inside ``apply_if_finite``) the model holds bfloat16 parameters and the
optimizer a float32 master of every trainable tensor, each its own buffer
even where the parameter is float32 already (the LayerNorms). The moments
are float32 over the masters; the gradients are lifted to float32 and the
whole clip + AdamW chain runs on the masters; each parameter is then set
to its master rounded to its own dtype (round to nearest even, as JAX's
``astype``: the bf16 parameter equals the rounded master bit for bit).
A step smaller than a bfloat16 ulp keeps accumulating in the master.
Skip-nonfinite wraps the masters too: a skipped step leaves masters,
moments, count and parameters as they were. The masters ride in
:meth:`~ClippedAdamW.state_dict`.

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
                 norm_groups: NormGroups | None = None, skip_nonfinite: bool = False,
                 max_consecutive_skips: int = 10):
        self.params = [p for p in params if p.requires_grad]
        # Under bf16_mixed the float32 masters the update runs on (a copy
        # each, float32 parameters included); the parameters themselves
        # otherwise.
        self.masters = None
        if cfg.precision == "bf16_mixed":
            self.masters = [p.detach().to(torch.float32, copy=True) for p in self.params]
        self.cfg = cfg
        self.fsdp = fsdp if fsdp is not None and fsdp.distributed else None
        self._sharded = (None if self.fsdp is None else
                         [self.fsdp.sharded(p) for p in self.params])
        self.norm_groups = norm_groups
        if norm_groups is not None and len(norm_groups.sharded) != len(self.params):
            raise ValueError("norm_groups.sharded needs one flag per parameter")
        self.lr = lr_schedule(cfg, total_steps)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.targets]
        self.nu = [torch.zeros_like(p) for p in self.targets]
        self.skip_nonfinite = skip_nonfinite
        if skip_nonfinite:
            dev = self.params[0].device
            self.max_consecutive_skips = max_consecutive_skips
            n = total_steps + 1 if cfg.schedule != "constant" else 1
            self._lr_table = torch.tensor([self.lr(c) for c in range(n)], device=dev)
            self.count = torch.zeros((), dtype=torch.int64, device=dev)
            self.notfinite_count = torch.zeros((), dtype=torch.int64, device=dev)
            self.total_notfinite = torch.zeros((), dtype=torch.int64, device=dev)

    @property
    def targets(self) -> list[torch.Tensor]:
        """What AdamW updates: the masters under bf16_mixed, else the
        parameters."""
        return self.params if self.masters is None else self.masters

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
        if self.masters is not None:
            grads = [g.float() for g in grads]
        norm = None
        if cfg.grad_clip > 0 or self.skip_nonfinite:
            norm = torch.linalg.vector_norm(self._param_norms(grads))
        if cfg.grad_clip > 0:
            factor = torch.where(norm < cfg.grad_clip, 1.0, cfg.grad_clip / norm)
            grads = torch._foreach_mul(grads, factor)
        if self.skip_nonfinite:
            self._step_if_finite(grads, torch.isfinite(norm))
        else:
            self._step(grads)
        if self.masters is not None:
            torch._foreach_copy_(self.params, self.masters)  # rounds to the params' dtype

    def _step(self, grads) -> None:
        """AdamW from the clipped ``grads`` on :attr:`targets`, in place."""
        cfg = self.cfg
        targets = self.targets
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
            torch._foreach_add_(upd, targets, alpha=cfg.weight_decay)
        torch._foreach_add_(targets, upd, alpha=-lr)

    def _step_if_finite(self, grads, finite: torch.Tensor) -> None:
        """AdamW from the clipped ``grads``, kept only where ``finite`` (or
        past ``max_consecutive_skips`` skips in a row): new moments and
        parameters are formed out of place and selected on the device."""
        cfg = self.cfg
        targets = self.targets
        self.notfinite_count = torch.where(finite, 0, self.notfinite_count + 1)
        self.total_notfinite = self.total_notfinite + (~finite).long()
        apply = finite | (self.notfinite_count > self.max_consecutive_skips)
        lr = self._lr_table[self.count.clamp(max=self._lr_table.numel() - 1)]
        c = (self.count + 1).float()
        b1, b2 = cfg.b1, cfg.b2
        mu = torch._foreach_mul(self.mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        nu = torch._foreach_mul(self.nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        den = torch._foreach_div(nu, 1.0 - torch.pow(b2, c))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        upd = torch._foreach_div(mu, 1.0 - torch.pow(b1, c))
        torch._foreach_div_(upd, den)
        if cfg.weight_decay:
            torch._foreach_add_(upd, targets, alpha=cfg.weight_decay)
        torch._foreach_mul_(upd, lr)
        new_p = torch._foreach_sub(targets, upd)
        for olds, news in ((self.mu, mu), (self.nu, nu), (targets, new_p)):
            for old, new in zip(olds, news):
                old.copy_(torch.where(apply, new, old))
        self.count = self.count + apply.long()

    def state_dict(self) -> dict:
        """The moments (in the parameters' order), the count, under
        bf16_mixed the masters and, with ``skip_nonfinite``, the skip
        counters (one host sync for the count there)."""
        state = {"count": int(self.count), "mu": list(self.mu), "nu": list(self.nu)}
        if self.masters is not None:
            state["master"] = list(self.masters)
        if self.skip_nonfinite:
            state.update(notfinite_count=self.notfinite_count.clone(),
                         total_notfinite=self.total_notfinite.clone())
        return state

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` (from any device) into this optimizer.
        Under bf16_mixed the masters come back and the parameters are set
        to them rounded; a state of the other precision is refused (the
        JAX package's fp32 and bf16_mixed states do not interconvert)."""
        if ("master" in state) != (self.masters is not None):
            raise ValueError(
                f"optimizer state of the other precision: this optimizer is "
                f"{self.cfg.precision}, the state "
                f"{'has' if 'master' in state else 'has no'} float32 masters")
        pairs = [(self.mu, state["mu"], "mu"), (self.nu, state["nu"], "nu")]
        if self.masters is not None:
            pairs.append((self.masters, state["master"], "master"))
        for mine, theirs, what in pairs:
            if len(theirs) != len(mine) or any(a.shape != b.shape
                                               for a, b in zip(mine, theirs)):
                raise ValueError(f"optimizer state {what}: shapes do not match the parameters")
            torch._foreach_copy_(mine, list(theirs))
        if self.masters is not None:
            torch._foreach_copy_(self.params, self.masters)
        if self.skip_nonfinite:
            dev = self.count.device
            self.count = torch.tensor(int(state["count"]), device=dev)
            self.notfinite_count = torch.as_tensor(state.get("notfinite_count", 0)).to(dev)
            self.total_notfinite = torch.as_tensor(state.get("total_notfinite", 0)).to(dev)
        else:
            self.count = int(state["count"])

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
                     fsdp=None, norm_groups: NormGroups | None = None,
                     skip_nonfinite: bool = False,
                     max_consecutive_skips: int = 10) -> ClippedAdamW:
    return ClippedAdamW(params, cfg, total_steps, fsdp, norm_groups, skip_nonfinite,
                        max_consecutive_skips)
