"""The training benchmark of ``graph_hscn_tpu_torch``: its harness, the
frozen traffic generators, the plain references and the comparison that
decides ``correct``.  Nothing here imports JAX or the JAX package.

The package sits under ``benchmarks/`` of a checkout; the program under
test is the checkout's ``graph_hscn_tpu_torch``, made importable here.
"""

from __future__ import annotations

import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# Every file the benchmark writes at run time (datasets) lives here, at a
# fixed path inside the checkout.
CACHE_DIR = BENCH_DIR / ".cache"

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
