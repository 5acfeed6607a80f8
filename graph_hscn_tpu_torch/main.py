"""CLI entry point of the PyTorch/CUDA port:
``python -m graph_hscn_tpu_torch.main --cfg configs/GCN/voc_superpixels_GCN_sparse.yaml``.

The counterpart of the repository's ``main.py`` (the same flags, the same
YAML schema), running on the CUDA card unless ``--device`` names another
device.  ``--eval best`` restores a snapshot from
``training.checkpoint_dir`` and scores val and test instead of training;
``--predict OUT.npz`` with it also exports the predictions.
"""

from __future__ import annotations

import argparse

from graph_hscn_tpu_torch.config.config import ExperimentConfig, load_config
from graph_hscn_tpu_torch.constants import LOGS_DIR
from graph_hscn_tpu_torch.runner import run_eval, run_experiment


def main() -> None:
    parser = argparse.ArgumentParser(description="Graph-HSCN PyTorch/CUDA "
                                                 "CLI")
    parser.add_argument("--cfg", type=str, required=True,
                        help="Config file to use.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: cuda; "
                             "'cpu' for a CPU run).")
    parser.add_argument("--eval", type=str, default=None, metavar="SNAP",
                        help="Eval-only mode: restore the named snapshot "
                             "('best' or 'latest') from "
                             "training.checkpoint_dir and score val/test "
                             "instead of training.")
    parser.add_argument("--predict", type=str, default=None,
                        metavar="OUT.npz",
                        help="With --eval: also export per-row prediction "
                             "scores and targets ({split}_scores / "
                             "{split}_targets) to the given .npz.")
    args = parser.parse_args()
    if args.predict and not args.eval:
        parser.error("--predict requires --eval")
    cfg: ExperimentConfig = load_config(args.cfg)
    LOGS_DIR.mkdir(parents=True, exist_ok=True)
    log_file = LOGS_DIR / (f"{cfg.data.dataset_name}_"
                           f"{cfg.training.model_type}_torch.log")
    if args.eval:
        run_eval(cfg, which=args.eval, device=args.device, log_file=log_file,
                 predict_out=args.predict)
    else:
        run_experiment(cfg, device=args.device, log_file=log_file)


if __name__ == "__main__":
    main()
