"""Train an edge-partition config on a mesh of D ranks and print its
per-epoch losses: the same run on 1 rank and on D ranks must agree (the
blocks' sums differ only in their order).

    python -m graph_hscn_tpu_torch.parallel.compare_ranks \\
        --cfg configs/GCN/voc_superpixels_GCN_edge_partition.yaml \\
        --ranks 1 --out one.json
    torchrun --nproc_per_node 4 -m graph_hscn_tpu_torch.parallel.compare_ranks \\
        --cfg configs/GCN/voc_superpixels_GCN_edge_partition.yaml \\
        --ranks 4 --against one.json

``mesh.shape`` becomes [ranks], ``training.max_epochs`` ``--epochs`` with
an eval every epoch (``--conv`` and ``--graphs`` set ``mp.conv_type`` and
``data.num_graphs``); every other key as the config has it.  Rank 0 prints
one JSON line (the ranks, each epoch's train, val and test loss, the
median train step ms on the synchronised host clock, the train split's
plan) and writes it to ``--out``; with ``--against`` (another run's
``--out``) it adds the largest relative difference of the losses.  On
the CPU pass ``--device cpu`` (gloo); on cards each rank takes
``cuda:LOCAL_RANK`` (NCCL).
"""

from __future__ import annotations

import argparse
import json
import statistics

from graph_hscn_tpu_torch.config.config import load_config
from graph_hscn_tpu_torch.parallel.mesh import this_rank
from graph_hscn_tpu_torch.runner import run_experiment

LOSSES = ("train_loss", "validation_loss", "test_loss")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--ranks", type=int, required=True)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--conv", default=None,
                        help="mp.conv_type to set (gcn, gin, gat)")
    parser.add_argument("--graphs", type=int, default=None,
                        help="data.num_graphs to set (a CPU rehearsal)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None)
    parser.add_argument("--against", default=None)
    args = parser.parse_args()
    cfg = load_config(args.cfg)
    cfg.mesh.shape = [args.ranks]
    cfg.training.epochs, cfg.training.eval_period = args.epochs, 1
    if args.conv:
        cfg.mpnn.conv_type = args.conv
    if args.graphs:
        cfg.data.num_graphs = args.graphs
    result = run_experiment(cfg, device=args.device, step_timing=True)
    if this_rank() != 0:
        return
    record = {"ranks": args.ranks, "conv": cfg.mpnn.conv_type,
              "losses": [[h[k] for k in LOSSES] for h in result.history],
              "step_ms": statistics.median(
                  s * 1e3 for s in result.step_seconds[1:]
                  or result.step_seconds),
              "train_plan": result.partition["train"]}
    if args.against:
        with open(args.against) as f:
            other = json.load(f)["losses"]
        record["max_rel_diff"] = max(
            abs(a - b) / max(abs(b), 1e-30)
            for mine, theirs in zip(record["losses"], other)
            for a, b in zip(mine, theirs))
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
