"""The port's edge-partitioned GCN and GIN
(graph_hscn_tpu_torch/parallel/sharded_gcn.py) against the JAX package's
``make_sharded_gcn`` / ``make_sharded_gin`` and ``fit_edge_partitioned``
on the same inputs, from JAX's init carried over
(``models/convert.py:sharded_*_params_from_jax``).

At D = 1 (one gloo rank in this process), 2 and 4 (gloo ranks, one
process each, ``tests/torch_dist.py``) against JAX at the same D on the
CPU mesh:
- logits within 1e-5 relative (|port - jax| <= 1e-5 * |jax| + 1e-6 *
  max|jax|), on the kernels' route (the rank's local-edge CsrPlan; the
  kernels' plain versions on the CPU) and on the plain one;
- the loss within 1e-5 relative, gradients within 1e-4 * max|ref|;
- 5 AdamW full-batch steps: each step's loss within 1e-4 relative, the
  final weights within 1e-4 * max|ref|.
bfloat16 tracks float32 within 0.05 * max|logits| with finite gradients
(JAX's own criterion, tests/test_sharded_gcn.py:98); the logits are
invariant under ``locality_reorder`` within 1e-5 * max|ref|; dropout's
masks differ across ranks and repeat for the same (seed, epoch).

``run_experiment`` on the shrunk edge-partition config (mesh.shape [1],
24 graphs, 3 epochs; GIN by its conv_type; GCN again on 4 ranks) follows
JAX's ``run_experiment`` from the same init: per-epoch train and val
losses within 1e-4 relative.  A resumed run follows the uninterrupted one
and ``run_eval`` scores its best snapshot (rtol 1e-5, atol 1e-6, JAX's
criterion), with the predict export.  JAX's refusals hold; GatedGCN,
GPS and the hybrid 2-D mesh, ported since, build and step on the same
config.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

import sharded_jax
from graph_hscn_tpu_torch.config.config import parse_config
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.parallel import sharded_gcn as psg
from graph_hscn_tpu_torch.parallel.mesh import make_mesh, process_group
from graph_hscn_tpu_torch.runner import run_eval, run_experiment
from sharded_jax import check_against_jax, follow_jax, run_ranks

ROOT = Path(__file__).parents[1]
GCN_EP = ROOT / "configs" / "GCN" / "voc_superpixels_GCN_edge_partition.yaml"
DIMS = {"gcn": [14, 64, 21], "gin": [14, 16, 21]}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("D", (1, 2, 4))
@pytest.mark.parametrize("conv", ("gcn", "gin"))
def test_sharded_model_matches_jax(conv, D, tmp_path):
    """The module docstring's criteria; GCN on 2 ranks also in bfloat16
    (halo payloads in bfloat16 over gloo: within 0.05 * max|logits|, loss
    and gradients finite) and on the locality-reordered batch (the same
    logits row for row, within 1e-5 * max|ref|)."""
    extra = ({"bf16": True, "reorder_check": True}
             if (conv, D) == ("gcn", 2) else {})
    out = check_against_jax(conv, D, DIMS[conv], tmp_path, **extra)
    if extra:
        ref = out["logits_plan"]
        scale = np.abs(ref).max()
        assert np.abs(out["logits_bf16"] - ref).max() <= 0.05 * scale
        assert out["bf16_finite"]
        np.testing.assert_allclose(out["logits_reordered"],
                                   ref[out["perm"]], rtol=0,
                                   atol=1e-5 * scale)


def test_sharded_gin_bf16_on_one_rank(tmp_path):
    out = run_ranks("sharded_model", 1, dict(
        conv="gin", dims=DIMS["gin"], heads=1,
        state=sharded_jax.as_port("gin", sharded_jax.init(
            "gin", DIMS["gin"])),
        batch=sharded_jax.voc_batch(1), steps=0, bf16=True), tmp_path)[0]
    scale = np.abs(out["logits_plan"]).max()
    assert np.abs(out["logits_bf16"] - out["logits_plan"]).max() <= (
        0.05 * scale)
    assert out["bf16_finite"]


def test_dropout_masks_per_rank():
    """The generator of (seed, epoch, rank): masks differ across ranks and
    epochs and repeat for the same triple; a dropout forward is the same
    function of its generator."""
    def mask(seed, epoch, rank):
        g = psg.dropout_generator(seed, epoch, rank, "cpu")
        return torch.rand(4096, generator=g) >= 0.3

    base = mask(3, 5, 0)
    assert torch.equal(base, mask(3, 5, 0))
    for other in (mask(3, 5, 1), mask(3, 6, 0), mask(4, 5, 0)):
        assert not torch.equal(base, other)
    model = psg.ShardedGCN(DIMS["gcn"], dropout=0.5,
                           generator=torch.Generator().manual_seed(0))
    model.train()
    batch = sharded_jax.voc_batch(1)
    with process_group(torch.device("cpu")):
        blk = psg.partition_arrays(
            *(batch[k] for k in sharded_jax.BATCH_KEYS),
            make_mesh(("data",), (1,)), reorder=False).block
        outs = [model(blk, psg.dropout_generator(0, 0, r, "cpu"))
                for r in (0, 0, 1)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("conv,D", [("gcn", 1), ("gin", 1), ("gcn", 4)])
def test_run_experiment_follows_jax(conv, D, tmp_path, monkeypatch):
    out = follow_jax(shrunk(conv=conv), D, tmp_path, monkeypatch)
    assert out["steps"] == 3
    assert out["partition"]["train"]["rows"] % (8 * D) == 0


def test_resume_and_eval_follow_the_uninterrupted_run(tmp_path):
    """A 4-epoch run cut after epoch 1 and resumed gives epochs 2-3's
    losses of the uninterrupted run (the same arithmetic on the restored
    state: equal within 1e-6 relative); run_eval of the best snapshot
    equals the fit's best val loss, its predict export holds each split's
    real rows."""
    def raw_in(directory, epochs):
        return shrunk(**{"training.checkpoint_dir": str(tmp_path / directory),
                         "training.checkpoint_every": 1,
                         "training.max_epochs": epochs,
                         "mp.dropout": 0.2})

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
    dm = DataModule.from_config(parse_config(raw_in("full", 4)).data)
    z = np.load(out)
    for split in ("val", "test"):
        rows = sum(dm.graphs[int(i)].num_nodes for i in dm.split_idx[split])
        assert z[f"{split}_scores"].shape == (rows, 21)
        assert z[f"{split}_targets"].shape == (rows, 21)


def shrunk(**kwargs) -> dict:
    return sharded_jax.shrunk(GCN_EP, **kwargs)


def _hybrid(raw):
    raw["mesh"].update(axes=["data", "model"], shape=[1, 1])


def _graph_level(raw):
    raw["data"]["dataset_name"] = "peptides_func"
    raw["data"]["task_level"] = "graph"
    raw["training"].update(loss_fn="cross_entropy", metric="ap")


@pytest.mark.parametrize("change,error,match", [
    (lambda raw: raw["mesh"].update(shape=[8]), ValueError,
     "needs 8 devices, have 1"),
    (lambda raw: raw["mp"].update(use_layer_norm=True), ValueError,
     "batch/layer norm"),
    (lambda raw: raw["training"].update(loss_fn="cross_entropy"),
     ValueError, "softmax_cross_entropy"),
    (lambda raw: raw["mp"].update(conv_type="gatedgcn"), None, None),
    (lambda raw: raw["mp"].update(conv_type="gps", num_heads=4,
                                  hidden_channels=16, num_layers=2),
     None, None),
    (lambda raw: raw["mesh"].update(shape=[2], edge_partition=False),
     ValueError, r"mesh.shape=\[2\] needs 2 devices, have 1"),
    (_hybrid, None, None),
    (_graph_level, ValueError, "node-level"),
    (lambda raw: raw.update(pe={"use": True}, compat={
        "frozen_random_signnet": False}), ValueError,
     "frozen_random_signnet"),
], ids=["shape8", "layer_norm", "loss_fn", "gatedgcn", "gps", "dp",
        "hybrid", "graph_level", "trainable_signnet"])
def test_mesh_refusals(change, error, match):
    """As JAX refuses them (runner.py:151-177, sharded_gcn.py:334-348).
    The paths that raised until their slice (``error`` None: GatedGCN,
    GPS, the hybrid 2-D mesh) build and step instead: two epochs, finite
    losses; a data-parallel mesh past the ranks raises JAX's
    device-count ValueError."""
    raw = shrunk()
    raw["data"]["num_graphs"] = 8
    change(raw)
    if error is None:
        raw["training"]["max_epochs"] = 2
        result = run_experiment(parse_config(raw), device="cpu")
        assert result.num_train_steps == 2
        assert all(np.isfinite(h["train_loss"]) for h in result.history)
    else:
        with pytest.raises(error, match=match):
            run_experiment(parse_config(raw), device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("name", [
    "GCN/voc_superpixels_GCN_edge_partition.yaml",
    "GAT/voc_superpixels_GAT_edge_partition.yaml"])
def test_shipped_configs_raise_on_one_rank(name, tmp_path):
    """The shipped shape [8] asks for 8 devices: on one rank it raises in
    both packages (JAX's device-count check, runner.py:159-163), in
    run_experiment and in run_eval."""
    raw = yaml.safe_load((ROOT / "configs" / name).read_text())
    raw["data"]["num_graphs"] = 8
    with pytest.raises(ValueError, match="needs 8 devices"):
        run_experiment(parse_config(raw), device="cpu")
    raw["training"]["checkpoint_dir"] = str(tmp_path / "ck")
    with pytest.raises(ValueError, match="needs 8 devices"):
        run_eval(parse_config(raw), device="cpu")
