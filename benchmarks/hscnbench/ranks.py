"""A cell on several cards: one process a card, started as torchrun
starts them (``parallel/compare_ranks.py``'s pattern), joined in one
process group that the port's runner finds and uses; rank 0 gathers what
the other ranks measured and prints the one result line.

:func:`launch` is the parent's side, :class:`Ranks` a rank's.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import time

# The parent's start on the wall clock, for the ranks' ``setup_s``.
START_VAR = "HSCNBENCH_START"


@dataclasses.dataclass
class Ranks:
    rank: int
    world: int
    device: object

    @classmethod
    def join(cls, device=None):
        """The launcher's group (torchrun's variables), joined on this
        rank's card (``cuda:LOCAL_RANK``; gloo on the CPU), or None for a
        process alone."""
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world == 1:
            return None
        import torch
        import torch.distributed as dist
        rank = int(os.environ["RANK"])
        if device is None or str(device).startswith("cuda"):
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(dev)
            backend = "nccl"
        else:
            dev, backend = torch.device(device), "gloo"
        dist.init_process_group(backend, init_method="env://",
                                world_size=world, rank=rank)
        return cls(rank, world, dev)

    def _tensor(self, value: float):
        import torch
        return torch.tensor([float(value)], dtype=torch.float64,
                            device=self.device)

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        import torch.distributed as dist
        t = self._tensor(flag)
        dist.broadcast(t, 0)
        return bool(t.item())

    def max(self, value: float) -> float:
        import torch.distributed as dist
        t = self._tensor(value)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def mean(self, value: float) -> float:
        import torch.distributed as dist
        t = self._tensor(value)
        dist.all_reduce(t)
        return float(t.item()) / self.world

    def leave(self) -> None:
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()


def start_time(t_start: float) -> float:
    """This process's ``perf_counter`` reading of the parent's start, for
    a rank; ``t_start`` for a process alone."""
    wall = os.environ.get(START_VAR)
    if wall is None:
        return t_start
    return time.perf_counter() - (time.time() - float(wall))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(script: str, argv: list[str], chips: int, t_start: float
           ) -> str | None:
    """Start ``chips`` ranks of ``script argv``, wait for every one, and
    return rank 0's standard output; None if a rank failed (which ends the
    others)."""
    env = dict(os.environ, WORLD_SIZE=str(chips), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    env[START_VAR] = repr(time.time() - (time.perf_counter() - t_start))
    with tempfile.TemporaryFile("w+") as out:
        procs = [subprocess.Popen(
            [sys.executable, script, *argv],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=out if r == 0 else subprocess.DEVNULL)
            for r in range(chips)]
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            print(f"ranks exited with {codes}", file=sys.stderr)
            return None
        out.seek(0)
        return out.read()
