"""Ring attention: causal attention with the sequence sharded over a ring of
ranks (the JAX package's ``ops/ring_attention.py``).

Rank i of a ring of R holds the contiguous sequence shard i of q, k, v
(``(B, T/R, H, D)``); key/value chunks travel around the ring while each
rank merges their contributions into its queries' output. Two schedules,
as in the JAX package:

- ``zigzag`` (default): the sequence is cut into 2R chunks and rank i
  works on chunks (C_i, C_{2R-1-i}), so every rank computes the same
  number of chunk pairs: three at step 0 (the local causal pair), then two
  a step, 2R+1 in all. The zigzag layout is reached from the contiguous
  shards by one exchange each way (chunk parity gives a clean 2-matching,
  :func:`_zigzag_perms`). Each chunk pair goes through the flash block
  kernels (:func:`~dtc_tpu_torch.ops.flash_attention.flash_block_forward`
  / ``flash_block_backward``; their plain versions for CPU tensors): the
  forward merges the blocks' normalised outputs by their lse, the backward
  re-rotates K/V for a second pass and runs each block's backward from the
  ring's merged lse and out, while the dk/dv accumulators travel with
  their K/V chunks and come home after a full cycle. The whole ring is one
  ``torch.autograd.Function`` (the JAX package's ``zigzag_flash`` custom
  VJP). On a CUDA tensor a head dim the kernels do not take raises, as
  the single-card flash path does (ROADMAP.md §B). On a CPU tensor such a
  head dim runs the same schedule on plain PyTorch blocks (``_block`` /
  ``_merge``), differentiated by autograd, as the JAX package does where
  its block kernels do not apply.
- ``uniform``: every rank computes all R full ``(T/R)²`` blocks, future
  ones masked; kept for the comparison of the two schedules.

The rank is a Python int in each process, so the JAX package's operand
selects on ``src < idx`` are branches here; the work per rank is the
same.

**Transports.** The schedules are written once per rank, as generators
that yield at each exchange a list of ``(perm, tensor)`` pairs (``perm[i]``:
where rank i's tensor goes; every perm is a permutation) and receive the
tensors that arrive. Two transports run them:

- :class:`DistRing`: this process's place in a ring of ``torch.distributed``
  processes (gloo on CPU, NCCL on cards, gloo ranks sharing a card), with
  point-to-point exchanges; under gloo a CUDA tensor travels through host
  buffers. A chunk whose perm keeps it home (the zigzag conversion's
  self-pairs) is copied locally: gloo refuses a send to one's own rank.
  The exchange is differentiable; its backward is the inverse exchange.
- :class:`InProcessRing`: R virtual ranks stepped in lockstep in one
  thread, over the global ``(B, T, H, D)`` tensors; an exchange hands each
  rank's tensor to its destination. It is the counterpart of the JAX
  package's virtual CPU devices, for the tests and for one card. (Threads
  as virtual ranks would deadlock: autograd runs every backward node of a
  device on one thread, so a rank blocked in an exchange would starve the
  others.)

A caller picks a ring explicitly or through :func:`use_ring`; without one
the ring has one rank and attention is dense, as in the JAX package.

``run(programs, overlap=True)`` hands a program a :class:`Pending`
instead of the tensors: the exchange is started and the program calls
``wait()`` when it needs what arrived, so it can queue work in between
(the FSDP ring of ``ops/overlap_collectives.py`` multiplies while the next
chunk travels). Such an exchange is not differentiable.
"""

from __future__ import annotations

import contextlib

import torch

from dtc_tpu_torch.ops import flash_attention as fa
from dtc_tpu_torch.ops.attention import dense_causal_attention

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

def _dst(pairs) -> tuple[int, ...]:
    """``[(src, dst), ...]`` (``lax.ppermute``'s form) as ``perm[src] = dst``."""
    return tuple(d for _, d in sorted(pairs))


def _inverse(perm) -> tuple[int, ...]:
    inv = [0] * len(perm)
    for src, dst in enumerate(perm):
        inv[dst] = src
    return tuple(inv)


class Pending:
    """The tensors of a started exchange: :meth:`wait` returns them once
    they have arrived. Over NCCL the wait orders the current stream after
    the transfer (the host does not block); over gloo it blocks the host.
    Holds the sent tensors until then, so no buffer of the transfer is
    freed and reused while it is in flight. ``staged``: ``(i, device)``
    for each tensor that arrives in a host buffer and is copied to
    ``device`` once it is there."""

    def __init__(self, tensors, works=(), sent=(), staged=()):
        self._tensors, self._works, self._sent = tensors, list(works), list(sent)
        self._staged = list(staged)

    def wait(self) -> list[torch.Tensor]:
        for work in self._works:
            work.wait()
        for i, device in self._staged:
            self._tensors[i] = self._tensors[i].to(device)
        self._works, self._sent, self._staged = [], [], []
        return self._tensors


class InProcessRing:
    """``size`` virtual ranks in one thread. Tensors are the global ones;
    :meth:`run` steps every rank's program to its next exchange, routes
    the tensors, and goes on until all return."""

    def __init__(self, size: int):
        self.size = size
        self.ranks = tuple(range(size))

    def position_offset(self, t: int) -> int:
        """First sequence position of the tokens a caller holds: all of them."""
        return 0

    def run(self, programs, overlap: bool = False) -> list:
        programs = list(programs)
        n = len(programs)
        results, sends, done = [None] * n, [None] * n, [False] * n

        def advance(i, value):
            try:
                sends[i] = programs[i].send(value)
            except StopIteration as stop:
                results[i], done[i] = stop.value, True

        for i in range(n):
            advance(i, None)
        while not all(done):
            perms = [None if done[i] else [p for p, _ in sends[i]] for i in range(n)]
            if any(d or p != perms[0] for d, p in zip(done, perms)):
                raise RuntimeError("the ring's programs fell out of step")
            recv = [[None] * len(perms[0]) for _ in range(n)]
            for i in range(n):
                for j, (perm, x) in enumerate(sends[i]):
                    recv[perm[i]][j] = x
            for i in range(n):
                advance(i, Pending(recv[i]) if overlap else recv[i])
        return results


class DistRing:
    """This process's place in a ring of ``torch.distributed`` processes.
    ``ranks_in_ring``: the global ranks of the ring in ring order (this
    process among them); ``group``: their process group (the world when
    None)."""

    def __init__(self, ranks_in_ring, group=None):
        import torch.distributed as dist

        self.global_ranks = tuple(ranks_in_ring)
        self.group = group
        self.size = len(self.global_ranks)
        self.ranks = (self.global_ranks.index(dist.get_rank()),)

    def position_offset(self, t: int) -> int:
        """First sequence position of this rank's ``t`` tokens."""
        return self.ranks[0] * t

    def exchange(self, perms, xs) -> list[torch.Tensor]:
        """Send ``xs[j]`` to ring rank ``perms[j][me]`` and receive from
        ``perms[j]``'s source of me, all in one batch of point-to-point
        operations; a self-pair is a local copy."""
        return self.start(perms, xs).wait()

    def start(self, perms, xs) -> Pending:
        """:meth:`exchange`, started: the transfers are in flight when this
        returns. Gloo moves CUDA tensors only in collectives, so under gloo
        a CUDA tensor travels through host buffers
        (``utils.dist._host_staged``): copied to the host before its send
        starts, and what arrives copied to the device in
        :meth:`Pending.wait`."""
        import torch.distributed as dist

        from dtc_tpu_torch.utils.dist import _host_staged

        me = self.ranks[0]
        ops, out, sent, staged = [], [], [], []
        for j, (perm, x) in enumerate(zip(perms, xs)):
            dst, src = perm[me], perm.index(me)
            if dst == me:
                out.append(x.clone())
                continue
            host = _host_staged(x, self.group)
            sent.append(x.detach().to("cpu", memory_format=torch.contiguous_format) if host
                        else x.contiguous())
            buf = torch.empty(x.shape, dtype=x.dtype, device="cpu" if host else x.device)
            ops.append(dist.P2POp(dist.isend, sent[-1], self.global_ranks[dst],
                                  self.group, j))
            ops.append(dist.P2POp(dist.irecv, buf, self.global_ranks[src], self.group, j))
            if host:
                staged.append((len(out), x.device))
            out.append(buf)
        works = dist.batch_isend_irecv(ops) if ops else []
        return Pending(out, works, sent, staged)

    def run(self, programs, overlap: bool = False) -> list:
        (program,) = programs
        value = None
        while True:
            try:
                sends = program.send(value)
            except StopIteration as stop:
                return [stop.value]
            perms, xs = tuple(p for p, _ in sends), [x for _, x in sends]
            value = (self.start(perms, xs) if overlap
                     else list(_Exchange.apply(self, perms, *xs)))


class _Exchange(torch.autograd.Function):
    """A :class:`DistRing` exchange; its backward sends each gradient back
    along the inverse permutation (``lax.ppermute``'s transpose)."""

    @staticmethod
    def forward(ctx, ring, perms, *xs):
        ctx.ring, ctx.perms = ring, perms
        out = ring.exchange(perms, xs)
        ctx.like = [(y.shape, y.dtype, y.device) for y in out]
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, dtype=dt, device=dev) if g is None else g
                 for g, (s, dt, dev) in zip(grads, ctx.like)]
        back = ctx.ring.exchange(tuple(_inverse(p) for p in ctx.perms), grads)
        return (None, None, *back)


_AMBIENT: list = []


@contextlib.contextmanager
def use_ring(ring):
    """Make ``ring`` the one :func:`ring_causal_attention` (and the model's
    ``attention: ring``) uses inside the block: the port's counterpart of
    the JAX package's ambient mesh."""
    _AMBIENT.append(ring)
    try:
        yield ring
    finally:
        _AMBIENT.pop()


def current_ring():
    """The innermost :func:`use_ring` ring, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


def position_offset(t: int) -> int:
    """First sequence position of a caller's ``t`` tokens under the
    current ring (0 without one)."""
    ring = current_ring()
    return 0 if ring is None else ring.position_offset(t)


# ---------------------------------------------------------------------------
# the zigzag layout
# ---------------------------------------------------------------------------

def _zigzag_perms(ring: int):
    """Contiguous->zigzag chunk routing as two permutations.

    Chunk c of 2R lives contiguously on rank c//2 (slot c%2) and in zigzag
    on rank z(c) = min(c, 2R-1-c) (slot 0 if c < R else 1). Restricted to
    one parity class z is injective, so parity yields a perfect 2-matching.
    Returns (perm_even, perm_odd) as ``(src, dst)`` pairs, perm_even[i] =
    (i, z(2i)): where rank i's even chunk goes.
    """
    z = lambda c: c if c < ring else 2 * ring - 1 - c
    perm_even = [(i, z(2 * i)) for i in range(ring)]
    perm_odd = [(i, z(2 * i + 1)) for i in range(ring)]
    return perm_even, perm_odd


def to_zigzag(idx: int, ring: int, xs):
    """Program: contiguous shards ``[C_2i, C_2i+1]`` (along dim 1) to
    zigzag ``[C_i, C_{2R-1-i}]``, for each tensor of ``xs``."""
    ev, od = (_dst(p) for p in _zigzag_perms(ring))
    sends = []
    for x in xs:
        lo, hi = x.chunk(2, dim=1)            # even chunk 2i, odd chunk 2i+1
        sends += [(ev, lo), (od, hi)]
    recv = yield sends
    out = []
    for j in range(len(xs)):
        r_even, r_odd = recv[2 * j], recv[2 * j + 1]
        # Slot 0 holds chunk idx, even iff idx is even.
        a, b = (r_even, r_odd) if idx % 2 == 0 else (r_odd, r_even)
        out.append(torch.cat([a, b], dim=1))
    return out


def from_zigzag(idx: int, ring: int, xs):
    """Program: the inverse of :func:`to_zigzag`."""
    ev, od = (_inverse(_dst(p)) for p in _zigzag_perms(ring))
    sends = []
    for x in xs:
        a, b = x.chunk(2, dim=1)              # chunks idx, 2R-1-idx
        even, odd = (a, b) if idx % 2 == 0 else (b, a)
        sends += [(ev, even), (od, odd)]
    recv = yield sends
    return [torch.cat([recv[2 * j], recv[2 * j + 1]], dim=1) for j in range(len(xs))]


# ---------------------------------------------------------------------------
# the zigzag ring on the flash block kernels (one autograd node)
# ---------------------------------------------------------------------------

def _halves(x: torch.Tensor):
    tc = x.shape[1] // 2
    return x[:, :tc].contiguous(), x[:, tc:].contiguous()


def _bcast(w: torch.Tensor, d: int) -> torch.Tensor:
    """A ``(B, H, tc)`` per-row weight over packed ``(B, tc, H·D)``."""
    return w.transpose(1, 2).repeat_interleave(d, dim=-1)


def _merge_lse(run, blk, d: int):
    """Merge a block's normalised ``(out, lse)`` into the running float32
    ``(out, lse)``."""
    out_run, lse_run = run
    o_b, lse_b = blk
    lse_new = torch.logaddexp(lse_run, lse_b)
    out_new = (out_run * _bcast(torch.exp(lse_run - lse_new), d)
               + o_b.float() * _bcast(torch.exp(lse_b - lse_new), d))
    return out_new, lse_new


def _flash_fwd_program(idx: int, ring: int, q, k, v, h: int):
    """One rank's zigzag forward on packed ``(B, 2·tc, H·D)`` zigzag-local
    chunks: ``(out in q's dtype, lse_a, lse_b)``, 2R+1 block forwards."""
    d = q.shape[2] // h
    kv = _dst([(i, (i + 1) % ring) for i in range(ring)])
    blk = lambda qc, kc, vc, causal: fa.flash_block_forward(qc, kc, vc, h, causal)
    qa, qb = _halves(q)
    ka, kb = _halves(k)
    va, vb = _halves(v)
    # Step 0: local causality over the chunk pair (three blocks).
    oa0, lse_a0 = blk(qa, ka, va, True)
    st_a = (oa0.float(), lse_a0)
    ob0, lse_b0 = blk(qb, ka, va, False)
    st_b = _merge_lse((ob0.float(), lse_b0), blk(qb, kb, vb, True), d)
    k_cur, v_cur = k, v
    for s in range(1, ring):
        k_cur, v_cur = yield [(kv, k_cur), (kv, v_cur)]
        src = (idx - s) % ring
        k0, k1 = _halves(k_cur)
        v0, v1 = _halves(v_cur)
        # q C_{2R-1-idx} x kv C_src: strictly past for every src != idx.
        st_b = _merge_lse(st_b, blk(qb, k0, v0, False), d)
        # src < idx: q C_idx x kv C_src; else q C_{2R-1-idx} x kv C_{2R-1-src}.
        if src < idx:
            st_a = _merge_lse(st_a, blk(qa, k0, v0, False), d)
        else:
            st_b = _merge_lse(st_b, blk(qb, k1, v1, False), d)
    out = torch.cat([st_a[0], st_b[0]], dim=1).to(q.dtype)
    return out, st_a[1], st_b[1]


def _flash_bwd_program(idx: int, ring: int, q, k, v, out, do, lse_a, lse_b, h: int):
    """One rank's zigzag backward: ``(dq, dk, dv)`` in the inputs' dtypes,
    2R+1 block backwards from the merged lse and out; dk/dv accumulators
    travel with their K/V chunks and are home after R exchanges."""
    kv = _dst([(i, (i + 1) % ring) for i in range(ring)])
    bwd = lambda qc, kc, vc, oc, lse, doc, causal: fa.flash_block_backward(
        qc, kc, vc, oc, lse, doc, h, causal)
    qa, qb = _halves(q)
    doa, dob = _halves(do)
    oa, ob = _halves(out)
    f32 = torch.float32
    dqa = torch.zeros(qa.shape, dtype=f32, device=q.device)
    dqb = torch.zeros_like(dqa)
    dk_acc = torch.zeros(k.shape, dtype=f32, device=k.device)
    dv_acc = torch.zeros_like(dk_acc)
    k_cur, v_cur = k, v
    for s in range(ring):
        src = (idx - s) % ring
        k0, k1 = _halves(k_cur)
        v0, v1 = _halves(v_cur)
        dk0, dk1, dv0, dv1 = (torch.zeros_like(dqa) for _ in range(4))
        if s == 0:
            dq_c, dk_c, dv_c = bwd(qa, k0, v0, oa, lse_a, doa, True)
            dqa += dq_c; dk0 += dk_c; dv0 += dv_c
            dq_c, dk_c, dv_c = bwd(qb, k0, v0, ob, lse_b, dob, False)
            dqb += dq_c; dk0 += dk_c; dv0 += dv_c
            dq_c, dk_c, dv_c = bwd(qb, k1, v1, ob, lse_b, dob, True)
            dqb += dq_c; dk1 += dk_c; dv1 += dv_c
        else:
            dq_c, dk_c, dv_c = bwd(qb, k0, v0, ob, lse_b, dob, False)
            dqb += dq_c; dk0 += dk_c; dv0 += dv_c
            if src < idx:
                dq_c, dk_c, dv_c = bwd(qa, k0, v0, oa, lse_a, doa, False)
                dqa += dq_c; dk0 += dk_c; dv0 += dv_c
            else:
                dq_c, dk_c, dv_c = bwd(qb, k1, v1, ob, lse_b, dob, False)
                dqb += dq_c; dk1 += dk_c; dv1 += dv_c
        dk_acc = dk_acc + torch.cat([dk0, dk1], dim=1)
        dv_acc = dv_acc + torch.cat([dv0, dv1], dim=1)
        # K/V have no use after the last step; the accumulators go home.
        if s != ring - 1:
            k_cur, v_cur, dk_acc, dv_acc = yield [(kv, k_cur), (kv, v_cur),
                                                  (kv, dk_acc), (kv, dv_acc)]
        else:
            dk_acc, dv_acc = yield [(kv, dk_acc), (kv, dv_acc)]
    dq = torch.cat([dqa, dqb], dim=1).to(q.dtype)
    return dq, dk_acc.to(k.dtype), dv_acc.to(v.dtype)


class _ZigzagFlash(torch.autograd.Function):
    """The whole ring over every local rank's packed zigzag chunks:
    ``apply(ring, h, *qs, *ks, *vs)`` -> one output per local rank."""

    @staticmethod
    def forward(ctx, ring, h, *xs):
        n = len(ring.ranks)
        qs, ks, vs = xs[:n], xs[n:2 * n], xs[2 * n:]
        res = ring.run(_flash_fwd_program(i, ring.size, q, k, v, h)
                       for i, q, k, v in zip(ring.ranks, qs, ks, vs))
        outs = [r[0] for r in res]
        ctx.ring, ctx.h = ring, h
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *(r[1] for r in res), *(r[2] for r in res))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        ring = ctx.ring
        n = len(ring.ranks)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, las, lbs = (saved[j * n:(j + 1) * n] for j in range(6))
        res = ring.run(
            _flash_bwd_program(i, ring.size, q, k, v, o, do.contiguous(), la, lb, ctx.h)
            for i, q, k, v, o, do, la, lb in zip(ring.ranks, qs, ks, vs, outs, douts, las, lbs))
        return (None, None, *(r[0] for r in res), *(r[1] for r in res), *(r[2] for r in res))


# ---------------------------------------------------------------------------
# the same schedule on plain blocks, and the uniform schedule
# ---------------------------------------------------------------------------

def _block(qc, kc, vc, scale: float, diag: bool):
    """One chunk pair: UNNORMALISED ``(m, l, o)`` in float32; ``diag``
    applies the causal mask of the chunk attending to itself."""
    s = torch.einsum("bthd,bshd->bhts", qc.float(), kc.float()) * scale
    if diag:
        tl = qc.shape[1]
        ar = torch.arange(tl, device=qc.device)
        s = torch.where(ar[None, :] <= ar[:, None], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p.to(vc.dtype).float(), vc.float())
    return m, l, o


def _merge(stats, blk):
    """Online-softmax merge of a block into the running ``(m, l, acc)``."""
    m_run, l_run, acc = stats
    m_b, l_b, o_b = blk
    m_new = torch.maximum(m_run, m_b)
    alpha = torch.exp(m_run - m_new)
    beta = torch.exp(m_b - m_new)
    l_new = alpha * l_run + beta * l_b
    acc_new = acc * alpha.transpose(1, 2)[..., None] + o_b * beta.transpose(1, 2)[..., None]
    return m_new, l_new, acc_new


def _dense_zigzag_program(idx: int, ring: int, qz, kz, vz):
    """One rank's zigzag schedule on plain blocks over ``(B, 2·tc, H, D)``
    zigzag-local chunks; output in q's dtype."""
    kv = _dst([(i, (i + 1) % ring) for i in range(ring)])
    scale = qz.shape[-1] ** -0.5
    qa, qb = qz.chunk(2, dim=1)
    ka, kb = kz.chunk(2, dim=1)
    va, vb = vz.chunk(2, dim=1)
    st_a = _block(qa, ka, va, scale, diag=True)
    st_b = _merge(_block(qb, ka, va, scale, diag=False), _block(qb, kb, vb, scale, diag=True))
    k_cur, v_cur = kz, vz
    for s in range(1, ring):
        k_cur, v_cur = yield [(kv, k_cur), (kv, v_cur)]
        src = (idx - s) % ring
        k0, k1 = k_cur.chunk(2, dim=1)
        v0, v1 = v_cur.chunk(2, dim=1)
        st_b = _merge(st_b, _block(qb, k0, v0, scale, diag=False))
        if src < idx:
            st_a = _merge(st_a, _block(qa, k0, v0, scale, diag=False))
        else:
            st_b = _merge(st_b, _block(qb, k1, v1, scale, diag=False))

    def finish(st):
        _, l, acc = st
        return acc / l.transpose(1, 2)[..., None]

    return torch.cat([finish(st_a), finish(st_b)], dim=1).to(qz.dtype)


def _uniform_program(idx: int, ring: int, q, k, v):
    """One rank's uniform schedule over its contiguous ``(B, T/R, H, D)``
    shard: all R blocks computed, the causal future masked."""
    b, tl, h, d = q.shape
    scale = d ** -0.5
    kv = _dst([(i, (i + 1) % ring) for i in range(ring)])
    ar = torch.arange(tl, device=q.device)
    m_run = torch.full((b, h, tl), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, h, tl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, tl, h, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for s in range(ring):
        src = (idx - s) % ring  # the global block the rotating K/V hold
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k_cur.float()) * scale
        mask = (src * tl + ar[None, :]) <= (idx * tl + ar[:, None])
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m_run, scores.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(scores - m_new[..., None])
        l_run = alpha * l_run + p.sum(dim=-1)
        acc = acc * alpha.transpose(1, 2)[..., None] + torch.einsum(
            "bhts,bshd->bthd", p.to(v_cur.dtype).float(), v_cur.float())
        m_run = m_new
        if s != ring - 1:
            k_cur, v_cur = yield [(kv, k_cur), (kv, v_cur)]
    return (acc / l_run.transpose(1, 2)[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def ring_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring=None, *,
                          schedule: str = "zigzag") -> torch.Tensor:
    """Causal attention over ``(B, T, H, D)`` with T sharded over ``ring``
    (:func:`current_ring` when None). Under a :class:`DistRing` the
    tensors are this rank's contiguous shard; under an
    :class:`InProcessRing` the whole sequence. The global T must divide by
    2R (zigzag) or R (uniform)."""
    if schedule not in ("zigzag", "uniform"):
        raise ValueError(f"unknown ring schedule {schedule!r}")
    ring = ring if ring is not None else current_ring()
    if ring is None or ring.size == 1:
        return dense_causal_attention(q, k, v)
    r, n = ring.size, len(ring.ranks)
    b, t_held, h, d = q.shape
    t = t_held * r // n
    shards = [x.chunk(n, dim=1) for x in (q, k, v)]
    if schedule == "uniform":
        if t % r != 0:
            raise ValueError(f"seq len {t} not divisible by ring size {r}")
        outs = ring.run(_uniform_program(i, r, *qkv) for i, *qkv in zip(ring.ranks, *shards))
        return torch.cat(outs, dim=1)
    if t % (2 * r) != 0:
        raise ValueError(
            f"seq len {t} not divisible by 2*ring size {2 * r} "
            "(zigzag needs two chunks per device)"
        )
    if q.is_cuda:
        fa.check_head_dim(d)  # the block kernels or nothing
    zz = ring.run(to_zigzag(i, r, qkv) for i, *qkv in zip(ring.ranks, *shards))
    if d in fa.KERNEL_HEAD_DIMS:
        pk = lambda x: x.reshape(b, x.shape[1], h * d)
        outs = _ZigzagFlash.apply(ring, h, *(pk(z[j]) for j in range(3) for z in zz))
        outs = [o.reshape(b, -1, h, d) for o in outs]
    else:
        outs = ring.run(_dense_zigzag_program(i, r, *z) for i, z in zip(ring.ranks, zz))
    back = ring.run(from_zigzag(i, r, [o]) for i, o in zip(ring.ranks, outs))
    return torch.cat([x[0] for x in back], dim=1)
