"""The device mesh on ``torch.distributed``: the counterpart of
``graph_hscn_tpu/parallel/mesh.py``.

JAX runs one controller over every device and shards arrays along a named
``jax.sharding.Mesh`` axis with ``shard_map``.  The port runs SPMD
processes instead, one rank a device, joined by a process group (NCCL on
CUDA, gloo on the CPU).  Each rank builds the same host plan from the same
data (it is deterministic) and keeps only its own block, so JAX's
``replicated`` and ``data_sharding`` placements have no counterpart here:
a replicated array is one that every rank holds whole, a sharded one the
block each rank holds.

- :func:`process_group` makes the group a run needs when none exists:
  from ``env://`` under ``torchrun`` (``WORLD_SIZE`` set; the rank's card
  is ``cuda:LOCAL_RANK``), else a 1-rank group on a ``FileStore`` in a
  temporary directory, without a network; it destroys what it made.
- :func:`resolve_mesh_shape` resolves ``-1`` against the group's world
  size, :func:`make_mesh` checks the shape against it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D or 2-D mesh of ranks: ``axes`` names, ``shape``, this
    process's ``rank`` in ``group`` of ``world_size`` ranks, and the
    ``device`` it runs on."""

    axes: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int
    world_size: int
    group: object
    device: torch.device

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def world_size() -> int:
    """The ranks of the default group, or of the group ``torchrun`` will
    make (``WORLD_SIZE``); 1 for a plain process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def this_rank() -> int:
    """This process's rank in the default group, or the one ``torchrun``
    gave it (``RANK``); 0 for a plain process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def resolve_mesh_shape(shape, world: int | None = None) -> list[int]:
    """A config mesh shape with ``-1`` ("all remaining ranks on that
    axis") resolved against ``world`` ranks (default :func:`world_size`)."""
    n = world_size() if world is None else world
    shape = list(shape)
    if -1 in shape:
        fixed = int(np.prod([s for s in shape if s != -1])) or 1
        shape[shape.index(-1)] = n // fixed
    return shape


def make_mesh(axes=("data",), shape=(-1,), device=None,
              group=None) -> Mesh:
    """The mesh over ``group`` (default: the default group).  A shape
    larger than the group raises JAX's ``ValueError``; a smaller one
    raises too, since every rank of an SPMD group runs the mesh's
    program."""
    n = dist.get_world_size(group)
    shape = resolve_mesh_shape(shape, n)
    total = int(np.prod(shape))
    if total > n:
        raise ValueError(f"mesh shape {shape} needs {total} devices, "
                         f"have {n}")
    if total < n:
        raise ValueError(f"mesh shape {shape} takes {total} ranks, the "
                         f"process group has {n}: start one process a "
                         "device of the mesh")
    return Mesh(tuple(axes), tuple(shape), dist.get_rank(group), n,
                group if group is not None else dist.group.WORLD,
                torch.device(device) if device is not None
                else torch.device("cpu"))


@contextlib.contextmanager
def process_group(device: torch.device):
    """Within the block a default process group exists; yields the device
    this rank runs on.  An existing group is used as it is (``device``
    unchanged).  Otherwise the group is made here and destroyed at the
    end: NCCL for a CUDA ``device``, gloo for the CPU; under ``torchrun``
    from ``env://``, the CUDA device then ``cuda:LOCAL_RANK``; else one
    rank on a ``FileStore`` in a temporary directory."""
    if dist.is_initialized():
        yield device
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    with contextlib.ExitStack() as stack:
        if "WORLD_SIZE" in os.environ:
            if device.type == "cuda":
                device = torch.device("cuda",
                                      int(os.environ.get("LOCAL_RANK", 0)))
                torch.cuda.set_device(device)
            dist.init_process_group(backend, init_method="env://")
        else:
            tmp = stack.enter_context(tempfile.TemporaryDirectory(
                prefix="graph_hscn_pg_"))
            store = dist.FileStore(os.path.join(tmp, "store"), 1)
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=1)
        try:
            yield device
        finally:
            dist.destroy_process_group()
