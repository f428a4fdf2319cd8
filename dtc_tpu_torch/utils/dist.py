"""Several processes: the port's counterpart of the JAX package's
``utils/dist.py`` (``maybe_initialize_distributed``, ``is_lead_process``).

Under ``torchrun`` (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` in the environment) :func:`initialize`
joins the process group: NCCL when the run is on cards, each rank on
``cuda:LOCAL_RANK``; gloo when the caller asks for the CPU. The caller may
name the backend: gloo on cards runs several ranks on one card (NCCL
refuses two ranks on one device, and :func:`initialize` raises when asked
for that). A rendezvous that fails raises: torchrun's environment is the
request for several processes, so training alone instead would be the
silent fallback the port forbids. Without that environment nothing is
initialized and the trainer is the single-process trainer.

:func:`isend` / :func:`recv` carry a tensor between two ranks (the
pipeline's activations and cotangents), and the ring's exchanges
(``ops/ring_attention.DistRing``) stage theirs the same way. Gloo moves
CUDA tensors in its collectives (``all_reduce``, ``broadcast``) but not
point to point, so under gloo a CUDA tensor goes through a host buffer,
copied explicitly on both sides (:func:`_host_staged`).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

#: How long a rank waits for the others at the rendezvous and in a
#: collective before it raises.
TIMEOUT_S = 300


def launched() -> bool:
    """Was this process started with a torchrun-style environment?"""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def initialize(device=None, backend: str | None = None) -> torch.device | None:
    """Join the process group named by the environment, if there is one
    and it is not joined yet. ``device``: the caller's device (``cuda``
    unless named): ``cuda`` puts each rank on ``cuda:LOCAL_RANK``, a named
    card (``cuda:0``) puts every rank on it, a CPU device selects gloo.
    ``backend``: ``nccl`` or ``gloo`` (by default NCCL on cards, gloo on
    the CPU); NCCL with two ranks of this host on one card raises. Returns
    this rank's device, or None without torchrun's environment."""
    if not launched():
        return None
    dev = torch.device("cuda" if device is None else device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo") or (backend == "nccl" and dev.type != "cuda"):
        raise ValueError(f"backend {backend!r} on {dev}: use nccl on cards or gloo")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        shared = (dev.index is not None and local_world > 1
                  or dev.index is None and local_world > torch.cuda.device_count())
        if backend == "nccl" and shared:
            raise ValueError(
                f"NCCL cannot run {local_world} ranks of this host on "
                f"{torch.cuda.device_count()} card(s): it refuses two ranks on one device. "
                "Give each rank its own card, or ask for backend='gloo' (--backend gloo) "
                "to run several ranks on one card")
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    try:
        dist.init_process_group(
            backend, init_method="env://", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S),
        )
    except Exception as e:
        raise RuntimeError(
            f"rank {rank} of {world} could not join the {backend} process group at "
            f"{os.environ.get('MASTER_ADDR')}:{os.environ.get('MASTER_PORT')}; the run asked "
            "for several processes and does not train alone"
        ) from e
    return dev


def teardown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_lead_process() -> bool:
    """Rank 0, or the only process: the one that logs and writes files."""
    return rank() == 0


def _host_staged(t: torch.Tensor, group=None) -> bool:
    """Does ``t`` travel point to point through a host buffer (a CUDA
    tensor under gloo, in ``group``: the world when None)?"""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def isend(t: torch.Tensor, dst: int):
    """Start sending ``t`` to global rank ``dst``. Returns the pending work
    and the buffer it reads, which the caller keeps alive until the work
    is waited on."""
    buf = t.detach().cpu() if _host_staged(t) else t.detach().contiguous()
    return dist.isend(buf, dst), buf


def recv(like: torch.Tensor, src: int) -> torch.Tensor:
    """Receive a tensor of ``like``'s shape, dtype and device from global
    rank ``src`` (blocking)."""
    staged = _host_staged(like)
    buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if staged else like.device)
    dist.recv(buf, src)
    return buf.to(like.device) if staged else buf


def barrier() -> None:
    """Wait for every rank (nothing in one process)."""
    if dist.is_initialized():
        dist.barrier()


def broadcast_int(value: int, device: torch.device) -> int:
    """Rank 0's ``value`` on every rank (itself in one process)."""
    if not dist.is_initialized():
        return value
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.broadcast(t, 0)
    return int(t.item())
