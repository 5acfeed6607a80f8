"""CLI entry point of the PyTorch/CUDA port:
``python -m graph_hscn_tpu_torch.main --cfg configs/GCN/voc_superpixels_GCN_sparse.yaml``.

The counterpart of the repository's ``main.py`` (same flag, same YAML
schema), training on the CUDA card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse

from graph_hscn_tpu_torch.config.config import ExperimentConfig, load_config
from graph_hscn_tpu_torch.constants import LOGS_DIR
from graph_hscn_tpu_torch.runner import run_experiment


def main() -> None:
    parser = argparse.ArgumentParser(description="Graph-HSCN PyTorch/CUDA "
                                                 "CLI")
    parser.add_argument("--cfg", type=str, required=True,
                        help="Config file to use.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default: cuda; "
                             "'cpu' for a CPU run).")
    args = parser.parse_args()
    cfg: ExperimentConfig = load_config(args.cfg)
    LOGS_DIR.mkdir(parents=True, exist_ok=True)
    log_file = LOGS_DIR / (f"{cfg.data.dataset_name}_"
                           f"{cfg.training.model_type}_torch.log")
    run_experiment(cfg, device=args.device, log_file=log_file)


if __name__ == "__main__":
    main()
