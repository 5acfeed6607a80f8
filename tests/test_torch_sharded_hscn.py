"""The port's edge-partitioned HSCN
(graph_hscn_tpu_torch/parallel/sharded_hscn.py) and the whole
edge-partitioned pipeline (parallel/sharded_scn.py:
``fit_hscn_edge_partitioned``) against the JAX package's
``make_sharded_hscn`` and ``fit_hscn_edge_partitioned`` on the same
inputs, from JAX's init carried over
(``models/convert.py:sharded_hscn_params_from_jax``).

At D = 1 (one gloo rank in this process), 2 and 4 (gloo ranks, one
process each, ``tests/torch_dist.py``), hidden 64, 2 layers, K = 4
clusters drawn at random, with the triangular pattern and 1 head (D = 1),
the clique and 2 heads with the virtual feedback (D = 2), the triangular
pattern and 4 heads with the feedback (D = 4), against JAX at the same D
on the CPU mesh:
- logits within 1e-5 relative (|port - jax| <= 1e-5 * |jax| + 1e-6 *
  max|jax|), with the rank's local-edge CsrPlan (the ll GCN through
  ``SpmmFunction``, ``csr_spmm``'s plain version here) and without;
- the loss within 1e-5 relative, gradients within 1e-4 * max|ref|.  The
  cluster sums sit inside each rank's own loss, so their backward sums
  the cotangents over the ranks; an identity backward would lose the
  other ranks' share, which D = 2 and 4 would see.  The feedback's
  weights start random there (its init is zero, and without it the lv
  and vv relations do not reach the loss);
- 3 AdamW steps: each step's loss within 1e-4 relative, the final
  weights held by the size of the update
  (``sharded_jax.assert_post_adam``).

``run_experiment`` on the shipped HSCN edge-partition config shrunk (24
graphs, 2 clustering epochs, 3 epochs) follows JAX's from the same init
of both stages: per-epoch losses within 1e-4 relative, ``run_eval``
scoring the best snapshot as the fit did, with the predict export.  A
resumed run (clustering again) follows the uninterrupted one.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import sharded_jax
from graph_hscn_tpu.parallel import sharded_hscn as jsh
from graph_hscn_tpu_torch.config.config import parse_config
from graph_hscn_tpu_torch.runner import run_eval, run_experiment
from sharded_jax import follow_jax

ROOT = Path(__file__).parents[1]
HSCN_EP = (ROOT / "configs" / "HSCN"
           / "voc_superpixels_HSCN_edge_partition.yaml")
HID, LAYERS, K = 64, 2, 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("D,pattern,heads,feedback", [
    (1, "triangular", 1, False), (2, "clique", 2, True),
    (4, "triangular", 4, True)])
def test_sharded_hscn_matches_jax(D, pattern, heads, feedback, tmp_path):
    batch = sharded_jax.voc_batch(D, num_graphs=3, seed=7, mean_nodes=100)
    n = batch["node_feat"].shape[0]
    clusters = np.random.default_rng(D).integers(0, K, n).astype(np.int32)
    params = jsh.init_sharded_hscn_params(
        jax.random.PRNGKey(2), 14, HID, 21, LAYERS, heads=heads,
        virtual_feedback=feedback)
    rng = np.random.default_rng(5)
    for layer in params["layers"] if feedback else ():
        # The feedback starts at zero, and the lv and vv relations reach
        # the loss only through it: random weights put the cluster sums'
        # backward on the gradient's path from the first step.
        layer["vl"]["kernel"] = rng.uniform(
            -0.2, 0.2, layer["vl"]["kernel"].shape).astype(np.float32)
    ref = sharded_jax.hscn_reference(D, params, batch, clusters, K,
                                     vv_pattern=pattern, heads=heads)
    init = sharded_jax.as_port("hscn", params)
    outs = sharded_jax.run_ranks("sharded_hscn", D, dict(
        state=init, batch=batch, clusters=clusters, model_kwargs=dict(
            hidden=HID, num_classes=21, num_layers=LAYERS, num_clusters=K,
            heads=heads, virtual_feedback=feedback, vv_pattern=pattern)),
        tmp_path)
    scale = np.abs(ref["logits"]).max()
    for out in outs:
        for key in ("logits_plan", "logits_plain"):
            np.testing.assert_allclose(out[key], ref["logits"], rtol=1e-5,
                                       atol=1e-6 * scale, err_msg=key)
        np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5)
        for name, g in ref["grads"].items():
            err = np.abs(out["grads"][name] - g).max()
            assert err <= 1e-4 * np.abs(g).max(), (name, err)
        np.testing.assert_allclose(out["step_losses"], ref["step_losses"],
                                   rtol=1e-4)
        sharded_jax.assert_post_adam(out["final"], ref["final"], init,
                                     0.01 * len(ref["step_losses"]))
    for out in outs[1:]:
        for name, w in outs[0]["final"].items():
            np.testing.assert_array_equal(out["final"][name], w)


def shrunk(**changes) -> dict:
    return sharded_jax.shrunk(HSCN_EP, **{"hscn.cluster_epochs": 2,
                                          **changes})


def test_run_experiment_follows_jax(tmp_path, monkeypatch):
    out = follow_jax(shrunk(), 1, tmp_path, monkeypatch)
    assert out["steps"] == 3


def test_resume_and_eval_follow_the_uninterrupted_run(tmp_path):
    """A 4-epoch run cut after epoch 1 and resumed (clustering again, as
    the snapshot holds the HSCN alone) gives epochs 2-3's losses of the
    uninterrupted run within 1e-6 relative; run_eval of the best
    snapshot equals the fit's best val loss (rtol 1e-5, atol 1e-6), its
    predict export holds each split's real rows."""
    def raw_in(directory, epochs):
        return shrunk(**{"training.checkpoint_dir": str(tmp_path / directory),
                         "training.checkpoint_every": 1,
                         "training.max_epochs": epochs,
                         "data.num_graphs": 12})

    full = run_experiment(parse_config(raw_in("full", 4)), device="cpu")
    cut = run_experiment(parse_config(raw_in("cut", 2)), device="cpu")
    resumed = run_experiment(parse_config(raw_in("cut", 4)), device="cpu")
    assert [h["epoch"] for h in cut.history] == [0, 1]
    assert [h["epoch"] for h in resumed.history] == [2, 3]
    for got, want in zip(resumed.history, full.history[2:]):
        for key in ("train_loss", "validation_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    out = tmp_path / "preds.npz"
    scores = run_eval(parse_config(raw_in("full", 4)), "best", device="cpu",
                      predict_out=str(out))
    np.testing.assert_allclose(scores["val"]["loss"], full.best_val_loss,
                               rtol=1e-5, atol=1e-6)
    z = np.load(out)
    for split in ("val", "test"):
        assert z[f"{split}_scores"].shape == z[f"{split}_targets"].shape
        assert z[f"{split}_scores"].shape[1] == 21
        assert np.isfinite(z[f"{split}_scores"]).all()
