"""The device mesh on ``torch.distributed``: the counterpart of
``graph_hscn_tpu/parallel/mesh.py`` and of ``utils/profiling.py:
maybe_init_distributed``.

JAX runs one controller over every device and shards arrays along a named
``jax.sharding.Mesh`` axis with ``shard_map``.  The port runs SPMD
processes instead, one rank a device, joined by a process group (NCCL on
CUDA, gloo on the CPU).  Each rank builds the same host plan from the same
data (it is deterministic) and keeps only its own block, so JAX's
``replicated`` and ``data_sharding`` placements have no counterpart here:
a replicated array is one that every rank holds whole, a sharded one the
block each rank holds.

- :func:`process_group` makes the group a run needs when none exists, as
  ``runtime.multihost`` says (JAX's ``maybe_init_distributed``): with a
  launcher's variables (:func:`launcher_env`: torchrun's ``WORLD_SIZE``,
  ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, or the JAX package's
  ``JAX_COORDINATOR_ADDRESS`` host:port, ``JAX_NUM_PROCESSES``,
  ``JAX_PROCESS_ID``) it joins their group, the rank's card
  ``cuda:LOCAL_RANK``; without them a 1-rank group on a ``FileStore`` in a
  temporary directory, without a network; it destroys what it made.
  "auto" joins only where the variables are set, "on" always (and raises
  without them), "off" never: each process is then its own 1-rank world.
- :func:`resolve_mesh_shape` resolves ``-1`` against the world size,
  :func:`make_mesh` checks the shape against the group.  A 2-D mesh
  ``("data", "model")`` of shape (Ddp, Dep) also gives each rank its data
  row's group (the Dep ranks ``g*Dep .. g*Dep + Dep - 1``, rank-major as
  JAX's ``mesh.devices.reshape(Ddp, Dep)``) and its coordinates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

MULTIHOST_MODES = ("auto", "on", "off")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D or 2-D mesh of ranks: ``axes`` names, ``shape``, this
    process's ``rank`` in ``group`` of ``world_size`` ranks, and the
    ``device`` it runs on.  A 2-D mesh adds ``row_group``, the ranks of
    this rank's data row (the last axis), and ``coords`` (row, column);
    on a 1-D mesh ``row_group`` is ``group`` and ``coords`` (rank,)."""

    axes: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int
    world_size: int
    group: object
    device: torch.device
    row_group: object = None
    coords: tuple[int, ...] = ()

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def launcher_env(mode: str = "auto", environ=None) -> dict | None:
    """The group a launcher asks this process to join: {"init_method",
    "world_size", "rank", "local_rank"}, or None where the process runs
    alone (no launcher variables, or ``mode`` "off").  torchrun's
    variables come first; else the JAX package's (``JAX_COORDINATOR_
    ADDRESS`` or the legacy ``COORDINATOR_ADDRESS`` as host:port, which
    rank 0 serves), so that a launch script written for the JAX package
    starts the port too.  ``mode`` "on" without variables raises, as JAX
    re-raises a failed ``jax.distributed.initialize`` under "on"."""
    if mode not in MULTIHOST_MODES:
        raise ValueError(f"runtime.multihost {mode!r}: one of "
                         f"{', '.join(MULTIHOST_MODES)}")
    env = os.environ if environ is None else environ
    if mode == "off":
        return None
    if "WORLD_SIZE" in env:
        rank = int(env.get("RANK", "0"))
        return {"init_method": "env://", "world_size": int(env["WORLD_SIZE"]),
                "rank": rank, "local_rank": int(env.get("LOCAL_RANK", rank))}
    address = env.get("JAX_COORDINATOR_ADDRESS") or env.get(
        "COORDINATOR_ADDRESS")
    if address:
        rank = int(env.get("JAX_PROCESS_ID", "0"))
        return {"init_method": f"tcp://{address}",
                "world_size": int(env.get("JAX_NUM_PROCESSES", "1")),
                "rank": rank, "local_rank": int(env.get("LOCAL_RANK", rank))}
    if mode == "on":
        raise RuntimeError(
            "runtime.multihost: on, but no launcher variables are set "
            "(torchrun's WORLD_SIZE/RANK/MASTER_ADDR/MASTER_PORT, or "
            "JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/JAX_PROCESS_ID)")
    return None


def world_size(mode: str = "auto") -> int:
    """The ranks of the default group, or of the group the launcher will
    make (:func:`launcher_env` under ``mode``); 1 for a process alone."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    env = launcher_env(mode if mode != "on" else "auto")
    return 1 if env is None else env["world_size"]


def this_rank(mode: str = "auto") -> int:
    """This process's rank in the default group, or the one the launcher
    gave it; 0 for a process alone."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    env = launcher_env(mode if mode != "on" else "auto")
    return 0 if env is None else env["rank"]


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
    program.  A 2-D shape makes the data rows' groups."""
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
    if len(shape) > 2:
        raise ValueError(f"mesh shape {shape}: 1-D or 2-D")
    rank = dist.get_rank(group)
    group = group if group is not None else dist.group.WORLD
    row_group, coords = group, (rank,)
    if len(shape) == 2:
        d_dp, d_ep = shape
        members = [dist.get_global_rank(group, i) for i in range(n)]
        # new_group is collective over the whole default group: every
        # rank makes every row's group, in the same order, or the ranks
        # that skip one wait for it forever.
        for row in range(d_dp):
            made = dist.new_group(members[row * d_ep:(row + 1) * d_ep])
            if row == rank // d_ep:
                row_group = made
        coords = (rank // d_ep, rank % d_ep)
    return Mesh(tuple(axes), tuple(shape), rank, n, group,
                torch.device(device) if device is not None
                else torch.device("cpu"), row_group, coords)


@contextlib.contextmanager
def process_group(device: torch.device, multihost: str = "auto"):
    """Within the block a default process group exists; yields the device
    this rank runs on.  An existing group is used as it is (``device``
    unchanged).  Otherwise the group is made here and destroyed at the
    end: NCCL for a CUDA ``device``, gloo for the CPU; the launcher's
    (:func:`launcher_env` under ``multihost``), the CUDA device then
    ``cuda:LOCAL_RANK`` (modulo the host's cards); else one rank on a
    ``FileStore`` in a temporary directory."""
    if dist.is_initialized():
        yield device
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    env = launcher_env(multihost)
    with contextlib.ExitStack() as stack:
        if env is not None:
            if device.type == "cuda":
                device = torch.device(
                    "cuda", env["local_rank"] % torch.cuda.device_count())
                torch.cuda.set_device(device)
            dist.init_process_group(backend, init_method=env["init_method"],
                                    world_size=env["world_size"],
                                    rank=env["rank"])
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
