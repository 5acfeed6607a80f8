"""The control of ``correct``, on the card: the reference put in the
program's place and computed in TF32 (the nearest precision below the
configurations' float32) has to fail one of a cell's limits, where the
program passes them all.  At the cells' own sizes (each seed a set-up and
the warm-up epochs: about 30 s on an H100), where the limits were set.

    python -m pytest benchmarks/test_bench_control.py -q -m gpu
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from hscnbench import harness, manifest  # noqa: E402

CELLS = ("peptides_func_hscn.device", "voc_gcn.host_sparse",
         "voc_gcn.device_dense")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_where_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("the control runs in TF32, which only a CUDA card has")
    limits = manifest.load_cell(name).workload["limits"]
    for seed in (11, 12, 13):
        r = harness.readings(name, seed)
        sound_ok, checks = harness.check.verdict(r["sound"], limits)
        assert sound_ok, (seed, {n: c for n, c in checks.items()
                                 if not c["value"] <= c["limit"]})
        control_ok, checks = harness.check.verdict(
            {**r["sound"], **r["control"]}, limits)
        assert not control_ok, (seed, checks)
