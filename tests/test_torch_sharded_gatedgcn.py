"""The port's edge-partitioned GatedGCN
(graph_hscn_tpu_torch/parallel/sharded_gatedgcn.py) against the JAX
package's ``make_sharded_gatedgcn`` and ``fit_edge_partitioned`` on the
same inputs, from JAX's init carried over
(``models/convert.py:sharded_gatedgcn_params_from_jax``).

At D = 1 (one gloo rank in this process), 2 and 4 (gloo ranks, one
process each, ``tests/torch_dist.py``), hidden 64, 2 layers, on a batch
with 3 edge features (drawn as JAX's own test draws them) whose local edge
groups end in padding edges, against JAX at the same D on the CPU mesh:
- logits within 1e-5 relative (|port - jax| <= 1e-5 * |jax| + 1e-6 *
  max|jax|) on the forced kernel route (``spmm_backend: pallas``: the
  local sums and the gathers' backwards through ``segment_reduce``'s
  plain version inside their autograd Functions) and on the plain one;
- the loss within 1e-5 relative, gradients within 1e-4 * max|ref| on
  both routes (the kernel drops the padding edges' cotangent rows, which
  the gate mask keeps zero);
- 5 AdamW full-batch steps: each step's loss within 1e-4 relative, the
  final weights held by the size of the update
  (``sharded_jax.assert_post_adam``: within 2e-3 of the distance
  travelled, every element within the sum of the lrs; JAX against
  itself at another D differs by 1.1e-3 here).
On 2 ranks bfloat16 tracks float32 within 0.05 * max|logits| with finite
gradients, and the logits of the locality-reordered batch (the plan's
edge indices composed through the re-sort, so each edge keeps its
features) are the same rows within 1e-5 * max|ref|.

``run_experiment`` on the shipped GatedGCN edge-partition config shrunk
(mesh.shape [1], 24 graphs, 3 epochs; no edge features: the zero edge
state) follows JAX's ``run_experiment`` from the same init: per-epoch
losses within 1e-4 relative, ``run_eval`` scoring the best snapshot as
the fit did, with the predict export.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import sharded_jax
from sharded_jax import check_against_jax, follow_jax

ROOT = Path(__file__).parents[1]
GATED_EP = (ROOT / "configs" / "GatedGCN"
            / "voc_superpixels_GatedGCN_edge_partition.yaml")
DIMS = [14, 64, 64, 21]
FE = 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("D", (1, 2, 4))
def test_sharded_gatedgcn_matches_jax(D, tmp_path):
    batch = sharded_jax.voc_batch(D, num_graphs=3, seed=23, mean_nodes=120,
                                  edge_features=FE)
    extra = {"bf16": True, "reorder_check": True} if D == 2 else {}
    out = check_against_jax(
        "gatedgcn", D, DIMS, tmp_path, batch=batch,
        init_kwargs={"edge_features": FE}, backend="pallas",
        plain_grads=True, build_kwargs={"edge_features": FE},
        adam_outliers=True, **extra)
    plan = out["ref"]["plan"]
    # Padding edges in every rank's local group: the kernel route drops
    # their rows.
    assert (~plan["mask_loc"]).any(axis=1).all()
    if extra:
        ref = out["logits_plan"]
        scale = np.abs(ref).max()
        assert np.abs(out["logits_bf16"] - ref).max() <= 0.05 * scale
        assert out["bf16_finite"]
        np.testing.assert_allclose(out["logits_reordered"],
                                   ref[out["perm"]], rtol=0,
                                   atol=1e-5 * scale)


def test_run_experiment_follows_jax(tmp_path, monkeypatch):
    raw = sharded_jax.shrunk(GATED_EP)
    assert raw["mp"]["conv_type"] == "gatedgcn"
    out = follow_jax(raw, 1, tmp_path, monkeypatch)
    assert out["steps"] == 3
