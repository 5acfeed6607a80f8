"""The port's edge-partitioned SCN, the MinCUT clustering stage
(graph_hscn_tpu_torch/parallel/sharded_scn.py), against the JAX package's
``make_sharded_scn`` on the same inputs, from JAX's init carried over
(``models/convert.py:sharded_scn_params_from_jax``).

At D = 1 (one gloo rank in this process), 2 and 4 (gloo ranks, one
process each, ``tests/torch_dist.py``), ``mp_units: [64, 64]`` and K = 8
clusters, against JAX at the same D on the CPU mesh:
- the MinCUT and orthogonality losses within 1e-5 relative, with the
  rank's local-edge CsrPlan (the second layer's 64-wide input through
  ``SpmmFunction``, ``csr_spmm``'s plain version here) and without;
- the gradients of their sum within 1e-4 * max|ref| on both routes.  The
  partials' sum over the ranks has an identity backward (every rank's
  loss is the whole loss); a sum whose backward summed too would give D
  times the gradient, which D = 2 and 4 would see;
- the argmax assignments equal on all real rows but at most one in 1000
  (a near-tie of two logits, rounded apart);
- 3 AdamW steps: each step's loss within 1e-4 relative, the final
  weights held by the size of the update
  (``sharded_jax.assert_post_adam``).
"""

import jax
import numpy as np
import pytest
import torch

import sharded_jax
from graph_hscn_tpu.parallel import sharded_scn as jss

MP_UNITS = [64, 64]
K = 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("D", (1, 2, 4))
def test_sharded_scn_matches_jax(D, tmp_path):
    batch = sharded_jax.voc_batch(D, num_graphs=3, seed=17, mean_nodes=100)
    params = jss.init_sharded_scn_params(jax.random.PRNGKey(3), 14,
                                         MP_UNITS, K)
    ref = sharded_jax.scn_reference(D, params, batch, K)
    init = sharded_jax.as_port("scn", params)
    outs = sharded_jax.run_ranks("sharded_scn", D, dict(
        mp_units=MP_UNITS, clusters=K, state=init, batch=batch), tmp_path)
    real = batch["node_mask"]
    for out in outs:
        for route in ("plan", "plain"):
            got = out[route]
            for key in ("mc", "o", "loss"):
                np.testing.assert_allclose(got[key], ref[key], rtol=1e-5,
                                           err_msg=f"{route} {key}")
            for name, g in ref["grads"].items():
                err = np.abs(got["grads"][name] - g).max()
                assert err <= 1e-4 * np.abs(g).max(), (route, name, err)
            differ = got["assign"][real] != ref["assign"][real]
            assert differ.sum() <= max(1, real.sum() // 1000), (
                route, int(differ.sum()))
        np.testing.assert_allclose(out["step_losses"], ref["step_losses"],
                                   rtol=1e-4)
        sharded_jax.assert_post_adam(out["final"], ref["final"], init,
                                     0.01 * len(ref["step_losses"]))
    for out in outs[1:]:
        for name, w in outs[0]["final"].items():
            np.testing.assert_array_equal(out["final"][name], w)
