"""The readings that a cell's limits are set from, on the card:

    python3 benchmarks/readings.py --workload <cell> --seeds 1,2,3 \
        [--out readings.jsonl]

For each seed, in one process (on several cards, one launch of the ranks
a seed), the program trains through the warm-up epochs at the cell's own
size, and the numbers ``correct`` compares are read against the reference
five ways (``hscnbench.harness.readings``): the program's; the control's
(the reference in TF32); two planted faults' (half of each batch left
out, no update); and the float32 reference's against float64.  One JSON
line a seed.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch
    from hscnbench import datasets, manifest, ranks
    from hscnbench.harness import readings
    cell = manifest.load_cell(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"readings of {args.workload} are taken on {cell.chips} CUDA "
              f"card(s); this machine has {cards}", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    if cell.chips > 1 and "WORLD_SIZE" not in os.environ:
        # One launch of the ranks a seed.
        datasets.ensure_dataset(cell.workload["data"])
        for seed in seeds:
            out = ranks.launch(__file__, ["--workload", args.workload,
                                          "--seeds", str(seed)]
                               + (["--out", args.out] if args.out else []),
                               cell.chips, 0.0)
            if out is None:
                return 1
            print(out.strip(), flush=True)
        return 0
    for seed in seeds:
        r = readings(args.workload, seed)
        if r is None:           # a rank other than 0
            continue
        line = json.dumps({"workload": args.workload, "seed": seed, **r})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
