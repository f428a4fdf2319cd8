"""Several processes: the port's counterpart of the JAX package's
``utils/dist.py`` (``maybe_initialize_distributed``, ``is_lead_process``).

Under ``torchrun`` (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` in the environment) :func:`initialize`
joins the process group: NCCL when the run is on cards, each rank on
``cuda:LOCAL_RANK``; gloo when the caller asks for the CPU. A rendezvous
that fails raises: torchrun's environment is the request for several
processes, so training alone instead would be the silent fallback the
port forbids. Without that environment nothing is initialized and the
trainer is the single-process trainer.
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


def initialize(device=None) -> torch.device | None:
    """Join the process group named by the environment, if there is one
    and it is not joined yet. ``device``: the caller's device (``cuda``
    unless named); a CPU device selects gloo. Returns this rank's device
    (``cuda:LOCAL_RANK`` on cards), or None without torchrun's
    environment."""
    if not launched():
        return None
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    backend = "nccl" if dev.type == "cuda" else "gloo"
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
