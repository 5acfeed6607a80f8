"""Project path constants (reference constants.py:3-6 — whose MODEL_DIR was
defined but never used; here they are actually wired: LOGS_DIR by main.py,
MODEL_DIR as the default checkpoint root, DATASETS_DIR by the real-data
loader)."""

from pathlib import Path

PROJECT_DIR = Path(__file__).resolve().parents[1]
DATASETS_DIR = PROJECT_DIR / "datasets"
LOGS_DIR = PROJECT_DIR / "logs"
MODEL_DIR = PROJECT_DIR / "models_ckpt"
