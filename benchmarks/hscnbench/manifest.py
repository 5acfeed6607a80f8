"""Finds what a run needs by the names in ``BENCHMARK.json``: the cell's
entry, its workload file (``workloads/<cell>.json``), its configuration
(the entry's ``file``) with the plain reference beside it
(``configs/<config>.py``), its route (``routes/<route>.py``) and each
per-layer metric's reader (``metrics/<metric>.py``).  A later cell,
configuration, route or metric is a new file and a new entry; no file here
changes for it."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

from hscnbench import BENCH_DIR, ROOT


def load_module(path: Path) -> ModuleType:
    """A module from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "hscnbench_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict           # the configuration file's content
    workload: dict         # the workload file's content
    reference: ModuleType  # configs/<config>.py
    route: ModuleType      # routes/<route>.py
    end_to_end: list       # BENCHMARK.json's end_to_end entries for the cell
    per_layer: list        # ... and per_layer entries


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest_path: Path | None = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """``manifest_path`` and ``bench_dir`` default to the checkout's
    ``BENCHMARK.json`` and ``benchmarks/``; the configuration's file is
    the entry's path under the manifest's directory."""
    manifest_path = manifest_path or ROOT / "BENCHMARK.json"
    with open(manifest_path) as f:
        manifest = json.load(f)
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {manifest_path.name}")
    entry = entries[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = configs[entry["config"]]
    cfg_path = manifest_path.parent / cfg_entry["file"]
    with open(cfg_path) as f:
        config = json.load(f)
    with open(bench_dir / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    return Cell(
        name=name, chips=int(entry["chips"]), config_name=entry["config"],
        config=config, workload=workload,
        reference=load_module(cfg_path.with_suffix(".py")),
        route=load_module(bench_dir / "routes" / f"{workload['route']}.py"),
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)])


def metric_reader(name: str) -> ModuleType:
    return load_module(BENCH_DIR / "metrics" / f"{name}.py")
