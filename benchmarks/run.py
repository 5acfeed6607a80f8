"""The training benchmark of graph_hscn_tpu_torch on NVIDIA GPUs.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card(s) of this machine: it
trains the cell's configuration through the port's fit entry for its
route, measures a window of at least ``--seconds`` (whole eval periods),
checks the first training steps and epoch 0 against the plain reference,
and prints one JSON line last on standard output: the end-to-end metrics
with ``--trace 0``, the per-layer metrics (and a ``breakdown`` of the
profiler's trace) with ``--trace 1``.  Without a CUDA card, or with fewer
cards than the cell asks for, it exits with 2 and prints no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (Linux's
    /proc), else the first line of this file."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime
                                      - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    t_start = process_start()

    import torch
    from hscnbench import datasets, manifest, ranks
    cell = manifest.load_cell(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {cards}", file=sys.stderr)
        return 2
    if cell.chips > 1 and "WORLD_SIZE" not in os.environ:
        # One rank a card; the dataset is written once, before them.
        datasets.ensure_dataset(cell.workload["data"])
        out = ranks.launch(__file__, sys.argv[1:] if argv is None else argv,
                           cell.chips, t_start)
        if not out or not out.strip():
            return 1
        line = out.strip().splitlines()[-1]
        report(json.loads(line))
        print(line, flush=True)
        return 0
    from hscnbench.harness import run_cell
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), ranks.start_time(t_start))
    if result is None:          # a rank other than 0
        return 0
    if "WORLD_SIZE" not in os.environ:
        report(result)
    print(json.dumps(result), flush=True)
    return 0


def report(result: dict) -> None:
    """Each number compared, beside its limit, last on standard error."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
