"""The port's edge-partitioned ring-attention GPS
(graph_hscn_tpu_torch/parallel/sharded_gps.py) against the JAX package's
``make_sharded_gps`` on the same inputs, from JAX's init carried over
(``models/convert.py:sharded_gps_params_from_jax``).

At D = 1 (one gloo rank in this process), 2 and 4 (gloo ranks, one
process each, ``tests/torch_dist.py``), hidden 16, 4 heads, key tiles of
24 rows (so a block spans several tiles and the last one is padded), with
the ``gcn`` local conv at D = 1 (2 layers) and 2 (1 layer) and the
``gatedgcn`` one at D = 1 (2 layers, the edge state carried from one to
the next; no edge features: the constant 1-column edge input) and 4 (1
layer, 3 edge features), against JAX at the same D on the CPU mesh:
- logits within 1e-5 relative (|port - jax| <= 1e-5 * |jax| + 1e-6 *
  max|jax|);
- the loss within 1e-5 relative, gradients within 1e-4 * max|ref|
  (through the ring's hops and their reverse, and the recomputed tiles);
  the key biases', zero in exact arithmetic (a bias shifts a query's
  scores all alike), within 1e-4 times the largest gradient of all;
- 3 AdamW full-batch steps: each step's loss within 1e-4 relative, the
  final weights held by the size of the update
  (``sharded_jax.assert_post_adam``), the key biases within the sum of
  the lrs (tests/test_torch_gps.py's criterion).
On 2 ranks with the GCN local conv bfloat16 tracks float32 within 0.05 *
max|logits| with finite gradients (JAX's own criterion), and the logits
are invariant under ``locality_reorder`` within 1e-5 * max|ref|.
"""

import numpy as np
import pytest
import torch

import sharded_jax
from sharded_jax import check_against_jax

HIDDEN = 16
HEADS = 4
TILE = 24
FE = 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("local,D,layers", [
    ("gcn", 1, 2), ("gatedgcn", 1, 2), ("gcn", 2, 1), ("gatedgcn", 4, 1)])
def test_sharded_gps_matches_jax(local, D, layers, tmp_path):
    fe = FE if (local == "gatedgcn" and D > 1) else None
    batch = sharded_jax.voc_batch(D, num_graphs=3, seed=31, mean_nodes=40,
                                  edge_features=fe or 0)
    extra = ({"bf16": True, "reorder_check": True}
             if (local, D) == ("gcn", 2) else {})
    dims = [14] + [HIDDEN] * (layers - 1) + [21]
    out = check_against_jax(
        "gps", D, dims, tmp_path, heads=HEADS, batch=batch,
        init_kwargs={"edge_features": fe, "local_conv": local,
                     "hidden": HIDDEN},
        make={"num_heads": HEADS, "tile": TILE, "local_conv": local},
        build_kwargs={"edge_features": fe, "local_conv": local,
                      "tile": TILE, "hidden": HIDDEN},
        adam_outliers=True, exact_zero=("attn.k.bias",), steps=3, **extra)
    nb = out["ref"]["plan"]["block_size"]
    assert nb > TILE and nb % TILE   # several tiles, the last one padded
    if extra:
        ref = out["logits_plan"]
        scale = np.abs(ref).max()
        assert np.abs(out["logits_bf16"] - ref).max() <= 0.05 * scale
        assert out["bf16_finite"]
        np.testing.assert_allclose(out["logits_reordered"],
                                   ref[out["perm"]], rtol=0,
                                   atol=1e-5 * scale)
