"""Checkpoints and resume: the counterpart of
``graph_hscn_tpu/train/checkpoint.py`` (which writes orbax trees).

  - ``save_best``   : the snapshot at each improving eval;
  - ``save_latest`` : the periodic resumable snapshot;
  - ``restore``     : the snapshot's tensors, loaded onto a device.

A snapshot is one ``torch.save`` file ``{dir}/{name}`` of a nested dict of
tensors (what the fit loop's ``get_state`` returns: the model's
``state_dict``, the optimizer wrapper's, the dropout generator's state and
the count of train steps), plus a ``{name}.meta.json`` sidecar.  Both are
written to a temporary name and renamed, the sidecar last: its presence
marks a complete snapshot (``has``).

Writes are asynchronous by default, as in the JAX package: ``_save`` copies
every tensor to host memory on the caller's thread, between steps, then
hands the host copy to one background thread for the file writes, so the
fit goes on stepping.  At most one write is in flight; every entry point
fences on it first, and a background failure re-raises at the next fence.
A save is a ``checkpoint.save`` span (utils/profiling.py) on the caller's
thread: the fence, the copy to host memory and the hand-off.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path

import torch

from graph_hscn_tpu_torch.utils.profiling import span


def to_host(tree):
    """``tree`` (dicts, lists and tuples of tensors and plain values) with
    every tensor copied to host memory."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _write_atomic(path: Path, write) -> None:
    """``write(tmp)`` to a temporary name beside ``path``, then rename it
    over ``path``."""
    tmp = path.with_name(path.name + ".tmp")
    write(tmp)
    os.replace(tmp, path)


class Checkpointer:
    def __init__(self, directory: str | Path, async_writes: bool = True):
        self.dir = Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.async_writes = async_writes
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self) -> None:
        """Block until any in-flight write has landed; re-raise its error."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, name: str, payload: dict, meta: dict) -> None:
        _write_atomic(self.dir / name, lambda p: torch.save(payload, p))
        # Written last: its presence marks a complete snapshot.
        _write_atomic(self.dir / f"{name}.meta.json",
                      lambda p: p.write_text(json.dumps(meta)))

    def _save(self, name: str, state: dict, meta: dict) -> None:
        self.wait()   # serialize: one write in flight, best/latest ordered
        payload = to_host(state)

        def write():
            try:
                self._write(name, payload, meta)
            except BaseException as e:    # surfaced at the next fence
                self._error = e

        if self.async_writes:
            t = threading.Thread(target=write, name=f"ckpt-write-{name}",
                                 daemon=True)
            t.start()
            self._pending = t
        else:
            write()
            self.wait()

    def save_best(self, state: dict, epoch: int, val_loss: float) -> None:
        with span("checkpoint.save"):
            self._save("best", state, {"epoch": epoch, "val_loss": val_loss})

    def save_latest(self, state: dict, epoch: int) -> None:
        with span("checkpoint.save"):
            self._save("latest", state, {"epoch": epoch})

    def restore(self, name: str, device: torch.device | str = "cpu"
                ) -> tuple[dict, dict]:
        """(the snapshot's tree, its tensors on ``device``; its sidecar
        metadata)."""
        self.wait()
        state = torch.load(self.dir / name, map_location=device,
                           weights_only=True)
        return state, self.meta(name)

    def has(self, name: str) -> bool:
        """A snapshot counts as present only when its sidecar exists: a
        crash between the two writes must not let resume restore epoch-N
        weights paired with a stale or absent epoch."""
        self.wait()
        return ((self.dir / name).exists()
                and (self.dir / f"{name}.meta.json").exists())

    def meta(self, name: str) -> dict:
        """Sidecar metadata of a snapshot without loading its tensors."""
        self.wait()
        meta_path = self.dir / f"{name}.meta.json"
        return json.loads(meta_path.read_text()) if meta_path.exists() \
            else {}
