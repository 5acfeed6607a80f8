"""Train a mesh config on D ranks and print its per-epoch losses: the same
run on 1 rank and on D ranks must agree (the blocks' or sub-batches'
sums differ only in their order).

    python -m graph_hscn_tpu_torch.parallel.compare_ranks \\
        --cfg configs/GCN/voc_superpixels_GCN_edge_partition.yaml \\
        --ranks 1 --out one.json
    torchrun --nproc_per_node 4 -m graph_hscn_tpu_torch.parallel.compare_ranks \\
        --cfg configs/GCN/voc_superpixels_GCN_edge_partition.yaml \\
        --ranks 4 --against one.json

``mesh.shape`` becomes [ranks], or ``--shape`` (e.g. ``2,2`` for the
hybrid 2-D mesh, ``1,1`` its one rank); ``training.max_epochs``
``--epochs`` with an eval every epoch (``--conv`` and ``--graphs`` set
``mp.conv_type`` and ``data.num_graphs``, ``--set section.field=value``
any other key, by the config object's names, ``mpnn`` for the YAML's
``mp``, the value read as YAML); every other key as the config has
it.  A config without ``mesh.edge_partition`` trains data-parallel
(``fit_dp``), on one rank too (``run_experiment``'s ``data_parallel``),
so that 1 rank and D ranks take the same global batches.  Rank 0 prints
one JSON line (the ranks, the shape, each epoch's train, val and test
loss, the median train step ms on the synchronised host clock, the train
split's plan where there is one) and writes it to ``--out``; with
``--against`` (another run's ``--out``) it adds the largest relative
difference of the losses.  On the CPU pass ``--device cpu`` (gloo); on
cards each rank takes ``cuda:LOCAL_RANK`` (NCCL).
"""

from __future__ import annotations

import argparse
import json
import statistics

import yaml

from graph_hscn_tpu_torch.config.config import load_config
from graph_hscn_tpu_torch.parallel.mesh import this_rank
from graph_hscn_tpu_torch.runner import run_experiment

LOSSES = ("train_loss", "validation_loss", "test_loss")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--ranks", type=int, required=True)
    parser.add_argument("--shape", default=None,
                        help="mesh.shape, comma-separated (default: ranks)")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--conv", default=None,
                        help="mp.conv_type to set (gcn, gin, gat, gps)")
    parser.add_argument("--graphs", type=int, default=None,
                        help="data.num_graphs to set (a CPU rehearsal)")
    parser.add_argument("--set", action="append", default=[],
                        metavar="SECTION.FIELD=VALUE",
                        help="another key to set (the value as YAML)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None)
    parser.add_argument("--against", default=None)
    args = parser.parse_args()
    cfg = load_config(args.cfg)
    cfg.mesh.shape = ([int(s) for s in args.shape.split(",")]
                      if args.shape else [args.ranks])
    cfg.training.epochs, cfg.training.eval_period = args.epochs, 1
    if args.conv:
        cfg.mpnn.conv_type = args.conv
    if args.graphs:
        cfg.data.num_graphs = args.graphs
    for item in args.set:
        key, value = item.split("=", 1)
        section, field = key.split(".")
        setattr(getattr(cfg, section), field, yaml.safe_load(value))
    result = run_experiment(cfg, device=args.device, step_timing=True,
                            data_parallel=not cfg.mesh.edge_partition)
    if this_rank() != 0:
        return
    record = {"ranks": args.ranks, "shape": list(cfg.mesh.shape),
              "conv": cfg.mpnn.conv_type,
              "losses": [[h[k] for k in LOSSES] for h in result.history],
              "step_ms": statistics.median(
                  s * 1e3 for s in result.step_seconds[1:]
                  or result.step_seconds),
              "train_plan": result.partition.get("train")}
    if args.against:
        with open(args.against) as f:
            other = json.load(f)["losses"]
        record["max_rel_diff"] = max(
            abs(a - b) / max(abs(b), 1e-30)
            for mine, theirs in zip(record["losses"], other, strict=True)
            for a, b in zip(mine, theirs))
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
