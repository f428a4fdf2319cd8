"""Pipeline parallelism: the port's counterpart of the JAX package's
``parallel/pipeline.py`` (GPipe fill-drain, 1F1B and interleaved 1F1B).

Layout (:class:`StageLayout`, the JAX package's ``pp_stack_params``): the
``n_layers`` layers are cut into ``C = S·V`` chunks of equal length;
chunk ``c = v·S + s`` is stage ``s``'s ``v``-th (virtual) chunk, so a
stage of plain pipelining (V 1) holds one contiguous run of layers. Stage 0
also holds the embedding and the last stage the head.

Schedules are static tables of lock-step ticks, per tick a forward and a
backward slot per stage, ``(microbatch, v)`` or ``(-1, -1)`` for idle:
:func:`simulate_interleaved` (a copy of the JAX package's, giving the same
tables; V 1 is plain 1F1B) and :func:`gpipe_rows` (all M forwards filling
and draining, then all M backwards in the reverse order of JAX's autodiff
through its clock scan).

:func:`run_schedule` executes a table on this rank's stage. Each rank runs
its own slots in tick order; what a neighbouring stage produced in tick
``t - 1`` (an activation for the next chunk, a cotangent for the previous
one) is received at the start of tick ``t``, and what this stage produces
is sent at once without waiting (:func:`dtc_tpu_torch.utils.dist.isend`).
Between one pair of ranks messages are sent and received in the same
order (forward before backward within a tick), so no tag is needed, and
no rank waits on one that waits on it. The port keeps each microbatch's
autograd graph from its forward slot to its backward slot, where the JAX
package recomputes the chunk's forward from a stashed input: a stage runs
each of its layers' flash forward once and its backward once per
microbatch (:func:`forward_slots`). The loss is the sum over microbatches
of their mean cross entropy divided by M (the JAX package's), formed on
the last stage.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dtc_tpu_torch.utils import dist as dist_utils


@dataclass(frozen=True)
class StageLayout:
    """Stage ``stage`` of ``stages``, ``virtual`` chunks a stage."""

    stage: int
    stages: int
    virtual: int = 1

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1

    def chunk(self, v: int) -> int:
        """The global index of this stage's ``v``-th chunk."""
        return v * self.stages + self.stage

    def layers(self, n_layers: int) -> list[int]:
        """The global indices of this stage's layers, chunk by chunk."""
        n_chunks = self.stages * self.virtual
        if n_layers % n_chunks:
            raise ValueError(
                f"n_layers={n_layers} not divisible by pipe*virtual="
                f"{self.stages}*{self.virtual} chunks")
        per = n_layers // n_chunks
        return [self.chunk(v) * per + k for v in range(self.virtual) for k in range(per)]


def simulate_interleaved(m: int, s_count: int, v_count: int = 1):
    """Static (interleaved) 1F1B schedule tables: the JAX package's
    ``simulate_interleaved``, the same greedy lock-step simulation and the
    same tables.

    The model is split into ``C = S*V`` chunks; chunk ``c = v*S + s`` runs
    on device ``s`` as its ``v``-th virtual stage (``V = 1`` is plain
    1F1B). Each tick every device runs at most one F slot and one B slot,
    picking among its V chunks the highest ready chunk (drain-first, which
    keeps the last chunk's backward in the same tick as its forward);
    forwards respect the Megatron warmup cap (``S - s`` chunk-slots for
    V=1, ``2(S-s-1) + (V-1)S + 1`` interleaved).

    Returns ``(rows, kf, kb)``: ``rows`` per tick a pair (frow, brow) of
    per-device ``(mb, v)`` tuples, ``(-1, -1)`` for an idle slot;
    ``kf`` / ``kb`` the most microbatches live at once per chunk in the
    activation stash / cotangent buffer (the JAX package's ring-buffer
    slot counts; the port keys its buffers by microbatch instead)."""
    c_count = s_count * v_count
    f_done = {(c, j): -1 for c in range(c_count) for j in range(m)}
    b_done = {(c, j): -1 for c in range(c_count) for j in range(m)}
    next_f = [0] * c_count
    next_b = [0] * c_count
    fcount = [0] * s_count
    bcount = [0] * s_count

    def warmup_cap(s: int) -> int:
        if v_count == 1:
            return s_count - s
        return 2 * (s_count - s - 1) + (v_count - 1) * s_count + 1

    rows = []
    kf = kb = 1
    tick = 0
    limit = 8 * (m * v_count + c_count) + 16
    while any(next_b[c] < m for c in range(c_count)) and tick < limit:
        frow = []
        for s in range(s_count):
            pick = (-1, -1)
            if fcount[s] - bcount[s] < warmup_cap(s):
                for v in reversed(range(v_count)):
                    c = v * s_count + s
                    j = next_f[c]
                    if j >= m:
                        continue
                    if c > 0 and not (0 <= f_done[(c - 1, j)] < tick):
                        continue
                    f_done[(c, j)] = tick
                    next_f[c] += 1
                    fcount[s] += 1
                    pick = (j, v)
                    break
            frow.append(pick)
        brow = []
        for s in range(s_count):
            pick = (-1, -1)
            for v in reversed(range(v_count)):
                c = v * s_count + s
                j = next_b[c]
                if j >= m:
                    continue
                if c == c_count - 1:
                    if not (0 <= f_done[(c, j)] <= tick):
                        continue
                elif not (0 <= b_done[(c + 1, j)] < tick):
                    continue
                b_done[(c, j)] = tick
                next_b[c] += 1
                bcount[s] += 1
                pick = (j, v)
                break
            brow.append(pick)
        rows.append((frow, brow))
        for c in range(c_count):
            arrived = next_f[c - 1] if c > 0 else next_f[0]
            kf = max(kf, arrived - next_b[c])
            if c < c_count - 1:
                kb = max(kb, next_b[c + 1] - next_b[c])
        tick += 1
    if any(next_b[c] < m for c in range(c_count)):
        raise RuntimeError(
            f"1f1b schedule did not converge for m={m} S={s_count} V={v_count}"
        )
    for j in range(m):
        for c in range(c_count):
            if f_done[(c, j)] < 0 or b_done[(c, j)] < 0:
                raise RuntimeError(f"chunk {c} of microbatch {j} never ran")
            if c > 0 and f_done[(c - 1, j)] >= f_done[(c, j)]:
                raise RuntimeError("forward dataflow broken")
            if c < c_count - 1 and b_done[(c + 1, j)] >= b_done[(c, j)]:
                raise RuntimeError("backward dataflow broken")
        if b_done[(c_count - 1, j)] != f_done[(c_count - 1, j)]:
            raise RuntimeError("the head's backward left its forward's tick")
    return rows, kf, kb


def simulate_1f1b(m: int, s_count: int):
    """Plain (V=1) 1F1B tables in per-microbatch row format: (JF, JB)
    per-tick lists of per-stage microbatch indices, -1 = idle."""
    rows, _, _ = simulate_interleaved(m, s_count, 1)
    jf_rows = [[j for j, _v in frow] for frow, _ in rows]
    jb_rows = [[j for j, _v in brow] for _, brow in rows]
    return jf_rows, jb_rows


def gpipe_rows(m: int, s_count: int):
    """GPipe's table in :func:`simulate_interleaved`'s row format: ``M + S
    - 1`` ticks in which stage ``s`` forwards microbatch ``tick - s``, then
    as many in which it runs the backward of microbatch ``M + S - 2 - r -
    s`` at backward tick ``r`` (last microbatch first, the order of
    autodiff through the JAX package's clock scan)."""
    n = m + s_count - 1
    idle = (-1, -1)

    def slot(j):
        return (j, 0) if 0 <= j < m else idle

    fwd = [([slot(t - s) for s in range(s_count)], [idle] * s_count) for t in range(n)]
    bwd = [([idle] * s_count, [slot(n - 1 - r - s) for s in range(s_count)])
           for r in range(n)]
    return fwd + bwd


def schedule_rows(schedule: str, m: int, stages: int, virtual: int = 1):
    """The table of ``pp_schedule`` (``gpipe`` or ``1f1b``)."""
    if schedule == "1f1b":
        return simulate_interleaved(m, stages, virtual)[0]
    if schedule != "gpipe" or virtual != 1:
        raise ValueError(f"pp_schedule {schedule!r} with {virtual} virtual stages")
    return gpipe_rows(m, stages)


def forward_slots(rows, stage: int) -> int:
    """The forward slots ``stage`` runs in a step of ``rows``: each runs its
    chunk's layers once (and their backward once)."""
    return sum(frow[stage][0] >= 0 for frow, _ in rows)


def run_schedule(model, rows, xs, ys, gen, mesh) -> torch.Tensor:
    """One step's forwards and backwards of this rank's stage (``model``
    holds it: ``model.layout``) under the table ``rows``, leaving the
    gradients in the parameters' ``.grad``. ``xs`` / ``ys``: the
    microbatches' inputs (read on the first stage) and targets (read on
    the last). ``mesh``: this rank's
    :class:`~dtc_tpu_torch.parallel.mesh.Mesh` (its ``prev_stage`` /
    ``next_stage``). Returns the sum over microbatches of their mean loss
    divided by M on the last stage, 0 on the others (float32 scalars)."""
    lay = model.layout
    s, n_stages = lay.stage, lay.stages
    n_chunks = n_stages * lay.virtual
    m = len(xs)
    cfg = model.cfg
    like = torch.empty(xs[0].shape + (cfg.d_model,), dtype=model.stage.blocks[0].cdtype,
                       device=xs[0].device)
    loss = torch.zeros((), dtype=torch.float32, device=like.device)
    arrived_f, arrived_g, stash, sent = {}, {}, {}, []
    for tick, (frow, brow) in enumerate(rows):
        if tick:
            # What the neighbours produced last tick, in the order they sent it.
            prev_f, prev_b = rows[tick - 1]
            j, v = prev_f[(s - 1) % n_stages]
            c = v * n_stages + (s - 1) % n_stages
            if j >= 0 and c + 1 < n_chunks:
                arrived_f[(j, (c + 1) // n_stages)] = dist_utils.recv(like, mesh.prev_stage)
            j, v = prev_b[(s + 1) % n_stages]
            c = v * n_stages + (s + 1) % n_stages
            if j >= 0 and c > 0:
                arrived_g[(j, (c - 1) // n_stages)] = dist_utils.recv(like, mesh.next_stage)
        j, v = frow[s]
        if j >= 0:
            c = lay.chunk(v)
            if c == 0:
                h_in, h = None, model.embed(xs[j], train=True, gen=gen)
            else:
                h_in = h = arrived_f.pop((j, v)).requires_grad_()
            out = model.run_chunk(v, h, train=True, gen=gen)
            if c == n_chunks - 1:
                out = model.head(out, ys[j]) / m
                loss += out.detach()
            else:
                sent.append(dist_utils.isend(out, mesh.next_stage))
            stash[(j, v)] = (h_in, out)
        j, v = brow[s]
        if j >= 0:
            c = lay.chunk(v)
            h_in, out = stash.pop((j, v))
            if c == n_chunks - 1:
                out.backward()
            else:
                out.backward(arrived_g.pop((j, v)))
            if c > 0:
                sent.append(dist_utils.isend(h_in.grad, mesh.prev_stage))
    for work, _ in sent:
        work.wait()
    if stash or arrived_f or arrived_g:
        raise RuntimeError("the schedule left work undone")
    return loss
