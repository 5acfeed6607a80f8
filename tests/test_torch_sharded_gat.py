"""The port's edge-partitioned multi-head GAT
(graph_hscn_tpu_torch/parallel/sharded_gcn.py:ShardedGAT) against the JAX
package's ``make_sharded_gat`` and ``fit_edge_partitioned`` on the same
inputs, from JAX's init carried over
(``models/convert.py:sharded_gat_params_from_jax``).

At D = 1 (one gloo rank in this process), 2 and 4 (gloo ranks, one
process each, ``tests/torch_dist.py``), 4 heads (``num_heads``' default),
hidden 64 (H*C = 64: ``spmm_mh`` on the kernels' route, with ``sddmm_mh``
for d alpha in its backward; the kernels' plain versions on the CPU) and
21 classes (H*C = 84), against JAX at the same D on the CPU mesh:
- logits within 1e-5 relative (|port - jax| <= 1e-5 * |jax| + 1e-6 *
  max|jax|), on the kernels' route and on the plain one;
- the loss within 1e-5 relative, gradients within 1e-4 * max|ref|;
- 5 AdamW full-batch steps: each step's loss within 1e-4 relative, the
  final weights within 1e-4 * max|ref|.
On 2 ranks bfloat16 tracks float32 within 0.05 * max|logits| with finite
gradients, and the logits are invariant under ``locality_reorder`` within
1e-5 * max|ref|.

``run_experiment`` on the shrunk GAT edge-partition config (24 graphs, 3
epochs) on 1 and 2 ranks follows JAX's ``run_experiment`` at the same D
from the same init: per-epoch train, val and test losses within 1e-4
relative; ``run_eval`` scores the best snapshot as the fit did (rtol
1e-5, atol 1e-6), with the predict export.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import sharded_jax
from sharded_jax import check_against_jax, follow_jax

ROOT = Path(__file__).parents[1]
GAT_EP = ROOT / "configs" / "GAT" / "voc_superpixels_GAT_edge_partition.yaml"
DIMS = [14, 64, 21]
HEADS = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("D", (1, 2, 4))
def test_sharded_gat_matches_jax(D, tmp_path):
    extra = {"bf16": True, "reorder_check": True} if D == 2 else {}
    out = check_against_jax("gat", D, DIMS, tmp_path, heads=HEADS, **extra)
    if extra:
        ref = out["logits_plan"]
        scale = np.abs(ref).max()
        assert np.abs(out["logits_bf16"] - ref).max() <= 0.05 * scale
        assert out["bf16_finite"]
        np.testing.assert_allclose(out["logits_reordered"],
                                   ref[out["perm"]], rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("D", (1, 2))
def test_run_experiment_follows_jax(D, tmp_path, monkeypatch):
    raw = sharded_jax.shrunk(GAT_EP)
    assert raw["mp"]["conv_type"] == "gat" and "num_heads" not in raw["mp"]
    out = follow_jax(raw, D, tmp_path, monkeypatch)
    assert out["steps"] == 3
