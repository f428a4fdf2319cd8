"""The ``(pipe, data, model)`` mesh over the ranks of a process group: the
port's counterpart of the JAX package's ``parallel/mesh.py``.

:func:`resolve_mesh_shape` is the JAX package's, with its validation and
messages. :class:`Mesh` places the ranks in the JAX mesh's device order,
row-major over ``(pipe, data, model)`` (model innermost), and holds the
process groups of the ranks that share every coordinate but one: the
``model`` group (Megatron tensor parallelism, or the ring of ``attention:
ring``), the ``data`` group (the gradient average) and the ``pipe`` group
(the stages of one pipeline), with this rank's previous and next stage.
:func:`check_fsdp` refuses the meshes FSDP does not run on yet (a pipe
axis); on the others FSDP's ring is the data group of this rank's model
index (``Mesh.data_ranks``).
"""

from __future__ import annotations

import itertools
import math

from dtc_tpu_torch.config.schema import MeshConfig

AXIS_NAMES = ("pipe", "data", "model")
PIPE, DATA, MODEL = AXIS_NAMES


def resolve_mesh_shape(
    parallel: str,
    num_devices: int,
    mesh: MeshConfig,
    n_layers: int | None = None,
    pipe_dcn: int = 1,
) -> tuple[int, int, int]:
    """Resolve ``(pipe, data, model)`` axis sizes.

    Zero entries in ``mesh`` are auto-filled from the strategy: the strategy's
    own axis absorbs all devices not claimed by explicit entries. Validates
    that the product covers every device. ``n_layers`` caps an auto-filled
    ``pipe`` at the largest divisor of the device budget that also divides
    ``n_layers`` (leftover devices become data parallelism), and an explicit
    ``pipe`` that does not divide ``n_layers`` is a ValueError. ``pipe_dcn``
    is the DCN factor of the pipe axis: divisibility is checked against
    ``pipe * pipe_dcn``.
    """
    sizes = {PIPE: mesh.pipe, DATA: mesh.data, MODEL: mesh.model}
    primary = {
        "dp": DATA, "tp": MODEL, "pp": PIPE, "none": DATA, "3d": None,
        "fsdp": DATA,
    }[parallel]

    if parallel == "3d":
        sizes = {k: (v or 1) for k, v in sizes.items()}
    else:
        explicit = {k: v for k, v in sizes.items() if v > 0}
        known = math.prod(explicit.values()) if explicit else 1
        if primary in explicit:
            sizes = {k: explicit.get(k, 1) for k in sizes}
        else:
            if num_devices % known != 0:
                raise ValueError(
                    f"explicit mesh axes {explicit} do not divide device count {num_devices}"
                )
            sizes = {k: explicit.get(k, 1) for k in sizes}
            sizes[primary] = num_devices // known
            if primary == PIPE and n_layers is not None:
                pipe = sizes[PIPE]
                while n_layers % (pipe * pipe_dcn) != 0 or sizes[PIPE] % pipe != 0:
                    pipe -= 1
                    if pipe == 0:
                        raise ValueError(
                            f"no pipe size <= {sizes[PIPE]} satisfies "
                            f"n_layers={n_layers} % (pipe * dcn_pipe={pipe_dcn}) == 0"
                        )
                if pipe != sizes[PIPE]:
                    print(
                        f"mesh: auto-pp capped pipe {sizes[PIPE]} -> {pipe} "
                        f"(n_layers={n_layers}); data "
                        f"{sizes[DATA]} -> {sizes[DATA] * (sizes[PIPE] // pipe)}"
                    )
                sizes[DATA] = sizes[DATA] * (sizes[PIPE] // pipe)
                sizes[PIPE] = pipe

    total_pipe = sizes[PIPE] * pipe_dcn
    if n_layers is not None and total_pipe > 1 and n_layers % total_pipe != 0:
        raise ValueError(
            f"pipe={sizes[PIPE]} x dcn_pipe={pipe_dcn} = {total_pipe} stages do "
            f"not divide n_layers={n_layers}; set mesh.pipe/dcn_pipe so their "
            "product divides the layer count"
        )

    shape = (sizes[PIPE], sizes[DATA], sizes[MODEL])
    if math.prod(shape) != num_devices:
        raise ValueError(
            f"mesh shape pipe×data×model = {shape} (= {math.prod(shape)}) "
            f"must equal the device count {num_devices}"
        )
    return shape


def coords(rank: int, shape: tuple[int, int, int]) -> tuple[int, int, int]:
    """``(pipe, data, model)`` of ``rank`` in the JAX mesh's device order."""
    _, d, m = shape
    return rank // (d * m), (rank // m) % d, rank % m


def check_fsdp(shape: tuple[int, int, int]) -> None:
    """Raise ``NotImplementedError`` for a ``parallel: fsdp`` mesh the port
    does not train on yet: one with a pipe axis. FSDP runs over the data
    axis, with Megatron tensor parallelism or ring attention on the model
    axis, each model index's data group its own ring."""
    if shape[0] > 1:
        raise NotImplementedError(
            "the PyTorch port does not train parallel: fsdp with a pipe axis yet "
            "(FSDP under pipeline parallelism, ROADMAP.md §A1)")


def rank_of(coord: tuple[int, int, int], shape: tuple[int, int, int]) -> int:
    """The rank at ``(pipe, data, model)``: the inverse of :func:`coords`."""
    _, d, m = shape
    return (coord[0] * d + coord[1]) * m + coord[2]


class Mesh:
    """This rank's place in a ``shape`` mesh over the ranks of the world
    process group. For each axis, ``<axis>_ranks`` are the global ranks
    that differ from this one only along it, in axis order, and
    ``<axis>_group`` their process group (None when the axis has one
    rank). Every rank creates every group of every axis, in one order, as
    ``torch.distributed.new_group`` requires. ``prev_stage`` /
    ``next_stage``: the ranks one stage before and after this one on the
    pipe axis (cyclically: the interleaved schedule wraps the last stage
    round to the first)."""

    def __init__(self, shape: tuple[int, int, int], rank: int):
        import torch.distributed as dist

        self.shape = shape
        self.rank = rank
        self.pipe_idx, self.data_idx, self.model_idx = here = coords(rank, shape)
        for axis, size in zip(AXIS_NAMES, shape):
            setattr(self, f"{axis}_ranks", (rank,))
            setattr(self, f"{axis}_group", None)
            if size == 1:
                continue
            k = AXIS_NAMES.index(axis)
            others = [range(n) for n in shape]
            others[k] = range(1)
            for fixed in itertools.product(*others):
                members = [rank_of(fixed[:k] + (i,) + fixed[k + 1:], shape)
                           for i in range(size)]
                group = dist.new_group(members)
                if rank in members:
                    setattr(self, f"{axis}_ranks", tuple(members))
                    setattr(self, f"{axis}_group", group)
        p = shape[0]
        self.prev_stage = rank_of(((here[0] - 1) % p,) + here[1:], shape)
        self.next_stage = rank_of(((here[0] + 1) % p,) + here[1:], shape)
