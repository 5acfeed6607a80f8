"""LRGB's GraphGPS in the port (``models/gps.py:GraphGPSModel``,
``models/encoders.py``, ``models/layers.py:BatchNorm``, ``mp.gps_layer:
graphgps``) held against the plain reference of the benchmark's cell
``peptides_func_gps`` (``benchmarks/configs/peptides_func_gps.py``, plain
torch, loaded by its path), at a small size on the CPU: hidden 16, 2
heads, 2 layers, LapPE 4 wide over 10 frequencies, five peptides of 8-40
nodes in six slots, some under 10 nodes so that frequencies are missing.

The program's batch is the device route's (``DeviceDataset`` and
``assemble`` on the CPU), the reference's its real nodes and edges;
both draw the sign flips and the attention dropout (0.5) from generators
of one seed, in the program's shapes and order.  Also: the default GPS
untouched, the mesh routes refusing the GraphGPS settings, a checkpoint
keeping the BatchNorm buffers, the eigen stats kept beside a dataset file,
and the attention counters.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graph_hscn_tpu_torch.config.config import PEConfig, parse_config
from graph_hscn_tpu_torch.data import synthetic as ts
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models import layers
from graph_hscn_tpu_torch.models.gps import GPSModel, GraphGPSModel
from graph_hscn_tpu_torch.models.mpnn import build_mpnn
from graph_hscn_tpu_torch.train.checkpoint import Checkpointer
from graph_hscn_tpu_torch.train.device_data import DeviceDataset, assemble
from graph_hscn_tpu_torch.train.loss import criterion
from graph_hscn_tpu_torch.train.optimizers import build_optimizer
from graph_hscn_tpu_torch.transform import posenc
from graph_hscn_tpu_torch.utils.logger import Logger

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
from hscnbench import reference  # noqa: E402


def _load_reference():
    path = BENCH / "configs" / "peptides_func_gps.py"
    spec = importlib.util.spec_from_file_location("ref_peptides_func_gps",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load_reference()
HIDDEN, HEADS, LAYERS, DIM_PE, FREQS, SLOTS, SEED = 16, 2, 2, 4, 10, 6, 11
CONFIG = {"run": {
    "data": {"dataset_name": "peptides_func", "batch_size": SLOTS},
    "mp": {"conv_type": "gps", "activation": "relu",
           "hidden_channels": HIDDEN, "num_layers": LAYERS,
           "num_heads": HEADS, "dropout": 0.0, "attn_dropout": 0.5,
           "gps_layer": "graphgps", "gps_local_conv": "gatedgcn"},
    "pe": {"use": True, "encoder": "lappe", "model": "DeepSet",
           "dim_pe": DIM_PE, "layers": 2, "post_layers": 0,
           "eig_max_freqs": FREQS, "eigvec_norm": "L2",
           "eig_lap_norm": "none"},
    "optim": {"optim_type": "adamW", "lr": 0.01, "weight_decay": 0.0,
              "clip_grad_norm": True, "schedule": "cosine",
              "warmup_steps": 1},
    "training": {"model_type": "gps", "loss_fn": "cross_entropy",
                 "metric": "ap", "max_epochs": 2, "eval_period": 1,
                 "patience": 1000000, "use_wandb": False}}}
DIMS = {"features": 9, "classes": 10, "edge_features": 3}
# float32 against float32 computed in another order (per graph against
# per slot, batch statistics over the real rows against masked sums): the
# logits of a forward to 2e-6 of their largest (the reading here 2.8e-7),
# a moving leaf's gradient to 2e-5 of its largest entry (1.6e-6); eval
# logits from the running statistics to 2e-5 (2.5e-7).
LOGITS_TOL, GRAD_TOL = 2e-6, 2e-5
# Three clipped AdamW steps (lr 0.01, warmup 1, cosine over 6): Adam
# divides by the root of the second moment, so an entry of a small
# gradient turns a rounding difference into a larger step; each moving
# leaf's change to 3e-4 of its largest entry (the reading 3.0e-5).
STEP_TOL = 3e-4


def _graphs():
    """Five peptides of 8-40 nodes, two under 10, with LapPE stats."""
    gs = ts.make_peptides_func(num_graphs=5, seed=3, mean_nodes=12.0)
    sizes = [g.num_nodes for g in gs]
    assert min(sizes) < FREQS and max(sizes) <= 40, sizes
    return [posenc.compute_posenc_stats(g, max_freqs=FREQS,
                                        eigvec_norm="L2",
                                        laplacian_norm="none") for g in gs]


def _program_batch(graphs):
    ds = DeviceDataset.build(graphs, device="cpu")
    idx = torch.tensor(list(range(len(graphs))) + [-1] * (SLOTS
                                                         - len(graphs)),
                       dtype=torch.int32)
    return assemble(ds, idx)


def _reference_batch(graphs, slot: int):
    n = np.array([g.num_nodes for g in graphs])
    e = np.array([g.num_edges for g in graphs])
    node_ptr = np.concatenate([[0], np.cumsum(n)])
    arrays = {
        "node_feat": np.concatenate([g.x for g in graphs]),
        "edge_index": np.concatenate(
            [g.edge_index + node_ptr[i] for i, g in enumerate(graphs)], 1),
        "edge_feat": np.concatenate([g.edge_attr for g in graphs]),
        "node_ptr": node_ptr, "edge_ptr": np.concatenate([[0],
                                                          np.cumsum(e)]),
        "y": np.stack([np.asarray(g.y).reshape(-1) for g in graphs])}
    rows = np.concatenate([i * slot + np.arange(k) for i, k in enumerate(n)])
    return reference.make_batch(arrays, list(range(len(graphs))), rows,
                                SLOTS * slot, "cpu")


def _model():
    pe = PEConfig(encoder="lappe", model="DeepSet", dim_pe=DIM_PE, layers=2,
                  post_layers=0, eigen_max_freqs=FREQS)
    return GraphGPSModel(9, HIDDEN, 10, LAYERS, num_heads=HEADS,
                         attn_dropout=0.5, num_edge_features=3, pe=pe,
                         generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def setup():
    graphs = _graphs()
    batch = _program_batch(graphs)
    rbatch = _reference_batch(graphs, batch.slot)
    spec = REF.targets(CONFIG, DIMS)["model"]
    weights = reference.make_weights(
        spec, SEED, "cpu", lambda n, s: REF.initial("model", n, s))
    return graphs, batch, rbatch, weights


def _loaded(weights):
    model = _model()
    missing, unexpected = model.load_state_dict(weights, strict=False)
    assert not unexpected
    assert all(k.endswith(("running_mean", "running_var")) for k in missing)
    return model


def _moving(ref_grads: dict) -> list:
    """The leaves whose gradient is not zero to rounding, by the
    benchmark's rule (``hscnbench.check.moving_leaves``): a bias that a
    BatchNorm after it removes (``local.A``, ``attn.value``,
    ``attn.out``, ``ffn1``) takes a gradient of round-off alone, and
    moves by Adam acting on it."""
    from hscnbench.check import moving_leaves
    return moving_leaves(ref_grads)


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _program_loss(model, batch, gen):
    pred = model(batch, generator=gen)
    return criterion("cross_entropy", pred, batch.y, batch.graph_mask)[0], \
        pred


def test_the_names_and_shapes_are_the_references(setup):
    _, _, _, weights = setup
    model = _model()
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        n: tuple(w.shape) for n, w in weights.items()}


def test_train_logits_and_gradients_match_the_reference(setup):
    _, batch, rbatch, weights = setup
    model = _loaded(weights)
    model.train()
    loss, pred = _program_loss(model, batch,
                               torch.Generator().manual_seed(SEED))
    # The last layer's edge state reaches no logit: its edge BatchNorm
    # takes no gradient on either side.
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(
        loss, list(model.parameters()), allow_unused=True)))
    params = {n: w.clone().requires_grad_(True) for n, w in weights.items()}
    drop = reference.Dropout(0.0, HIDDEN, SEED, "cpu")
    ref_logits = REF.forward(params, rbatch, drop)
    ref_loss = REF.loss(ref_logits, rbatch)
    ref_grads = dict(zip(params, torch.autograd.grad(
        ref_loss, list(params.values()), allow_unused=True)))
    G = rbatch.num_graphs
    assert _rel(pred[:G], ref_logits) <= LOGITS_TOL
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-6)
    unused = {n for n, g in grads.items() if g is None}
    assert unused == {n for n, g in ref_grads.items() if g is None} == {
        f"layers.{LAYERS - 1}.local.norm_e.{k}" for k in ("scale", "bias")}
    moving = _moving({n: g for n, g in ref_grads.items() if g is not None})
    assert len(moving) > len(names) // 2
    for n in moving:
        assert _rel(grads[n], ref_grads[n]) <= GRAD_TOL, n


def _trajectories(batch, rbatch, weights, steps: int = 3,
                  sync: bool = False):
    """Three clipped, warmed-up AdamW steps of each side on the batch, the
    draws of each step following the last's: the weights after each step,
    the leaves that move, and the two models' eval logits after them (the
    running statistics each side kept).  ``sync``: the reference takes
    the program's weights after each step, so that the running statistics
    are compared alone."""
    model = _loaded(weights)
    opt = build_optimizer(model.parameters(), "adamW", 0.01, 0.0,
                          clip_grad_norm=True, schedule="cosine",
                          warmup_steps=1, total_steps=6)
    gen = torch.Generator().manual_seed(SEED)
    params = {n: w.clone().requires_grad_(True) for n, w in weights.items()}
    adam = reference.AdamW(params, 0.01, 0.0, schedule=reference.lr_schedule(
        0.01, "cosine", 1, 6))
    drop = reference.Dropout(0.0, HIDDEN, SEED, "cpu")
    stats: dict = {}
    mine, theirs = [], []
    for _ in range(steps):
        model.train()
        loss, _ = _program_loss(model, batch, gen)
        opt.zero_grad()
        loss.backward()
        opt.step()
        mine.append({n: p.detach().clone()
                     for n, p in model.named_parameters()})
        ref_loss = REF.loss(REF.forward(params, rbatch, drop, stats), rbatch)
        g = torch.autograd.grad(ref_loss, list(params.values()),
                                allow_unused=True)
        g = {n: torch.zeros_like(params[n]) if d is None else d
             for n, d in zip(params, g)}
        adam.step(params, reference.clip_by_global_norm(g))
        theirs.append({n: p.detach().clone() for n, p in params.items()})
        moving = _moving(g) if not theirs[1:] else moving
        if sync:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(mine[-1][n])
    model.eval()
    with torch.no_grad():
        eval_mine = model(batch)[:rbatch.num_graphs]
        eval_theirs = REF.forward(params, rbatch, None, stats, train=False)
    return mine, theirs, moving, eval_mine, eval_theirs


def test_three_clipped_warmed_up_steps_match_the_reference(setup):
    _, batch, rbatch, weights = setup
    mine, theirs, moving, _, _ = _trajectories(batch, rbatch, weights)
    assert len(moving) > len(weights) // 2
    for step, (a, b) in enumerate(zip(mine, theirs)):
        for n in moving:
            assert _rel(a[n] - weights[n], b[n] - weights[n]) <= STEP_TOL, \
                (step, n)
            assert not torch.equal(a[n], weights[n]) or step == 0, n


def test_eval_logits_with_running_statistics_match(setup):
    _, batch, rbatch, weights = setup
    *_, eval_mine, eval_theirs = _trajectories(batch, rbatch, weights,
                                               sync=True)
    assert _rel(eval_mine, eval_theirs) <= LOGITS_TOL * 10


def test_batch_norm_over_padding_is_caught(setup, monkeypatch):
    """BatchNorm statistics taken over the padding rows too: the logits
    miss the reference's by far more than the tolerance."""
    _, batch, rbatch, weights = setup
    forward = layers.BatchNorm.forward
    monkeypatch.setattr(layers.BatchNorm, "forward",
                        lambda self, x, mask: forward(
                            self, x, torch.ones_like(mask)))
    model = _loaded(weights)
    model.train()
    _, pred = _program_loss(model, batch, torch.Generator().manual_seed(SEED))
    drop = reference.Dropout(0.0, HIDDEN, SEED, "cpu")
    ref_logits = REF.forward(weights, rbatch, drop)
    assert _rel(pred[:rbatch.num_graphs], ref_logits) > 1e3 * LOGITS_TOL


def test_missing_frequencies_survive_the_device_dataset(setup):
    """The device dataset keeps each graph's missing pairs: the assembled
    batch holds NaN there, as the host batches do, and 0 on padding."""
    graphs, batch, _, _ = setup
    ds = DeviceDataset.build(graphs, device="cpu")
    small = [i for i, g in enumerate(graphs) if g.num_nodes < FREQS]
    assert small
    for i, g in enumerate(graphs):
        assert ds.eig_ok[i].tolist() == [k < g.num_nodes
                                         for k in range(FREQS)]
        rows = batch.eigvecs[i * batch.slot:(i + 1) * batch.slot]
        np.testing.assert_array_equal(rows[:g.num_nodes].numpy(),
                                      g.eigvecs)
        assert torch.equal(rows[g.num_nodes:],
                           torch.zeros_like(rows[g.num_nodes:]))
    assert torch.isnan(batch.eigvals).any()


def test_the_default_gps_is_untouched():
    """The shipped GPS (``gps_layer`` and ``attn_dropout`` at their
    defaults) builds today's ``GPSModel``, and in training draws the node
    dropout's bits alone: after a forward its generator stands where
    three [N, H] draws a layer leave one of the same seed.  Attention
    dropout on it is refused: GraphGPS alone reads it."""
    raw = {k: dict(v) for k, v in CONFIG["run"].items() if k != "pe"}
    raw["mp"] = {"conv_type": "gps", "activation": "relu",
                 "hidden_channels": HIDDEN, "num_layers": LAYERS,
                 "num_heads": HEADS, "dropout": 0.1}
    cfg = parse_config(raw)
    assert (cfg.mpnn.gps_layer, cfg.mpnn.attn_dropout) == ("prenorm", 0.0)
    with pytest.raises(ValueError, match="attn_dropout is read by "
                       "gps_layer graphgps alone"):
        parse_config({**raw, "mp": {**raw["mp"], "attn_dropout": 0.5}})
    model = build_mpnn(cfg.mpnn, 9, 10,
                       generator=torch.Generator().manual_seed(0))
    assert type(model) is GPSModel
    assert all(layer.attn.dropout == 0.0 for layer in model.layers)
    graphs = _graphs()
    batch = _program_batch(graphs).replace(eigvecs=None, eigvals=None)
    model.train()
    gen = torch.Generator().manual_seed(5)
    model(batch, generator=gen)
    twin = torch.Generator().manual_seed(5)
    for _ in range(3 * LAYERS):
        torch.rand((batch.num_nodes_padded, HIDDEN), generator=twin)
    assert torch.equal(gen.get_state(), twin.get_state())


def _cfg(pe: bool = True, **mp):
    raw = {k: dict(v) for k, v in CONFIG["run"].items()
           if pe or k != "pe"}
    raw["mp"].update(mp)
    return parse_config(raw)


def test_the_mesh_routes_refuse_the_graphgps_settings(monkeypatch):
    from graph_hscn_tpu_torch import runner
    from graph_hscn_tpu_torch.parallel.hybrid import fit_hybrid
    from graph_hscn_tpu_torch.parallel.sharded_gcn import \
        fit_edge_partitioned
    cfg = _cfg()
    for fit in (fit_hybrid, fit_edge_partitioned):
        with pytest.raises(ValueError, match="mp.gps_layer: graphgps"):
            fit(None, None, cfg.mpnn, cfg.optim, cfg.training, None)
    monkeypatch.setattr(runner, "world_size", lambda *a: 2)
    dm = type("DM", (), {"task_level": "graph"})()
    with pytest.raises(ValueError, match="'dp' does not run mp.gps_layer: "
                       "graphgps, pe.encoder: lappe"):
        runner._dispatch(cfg, dm, "cpu", None, None, False, True)
    cfg.mesh.shape = [2]
    with pytest.raises(ValueError, match="pe.encoder: lappe"):
        runner._dispatch(cfg, dm, "cpu", None, None, False, False)


def test_a_checkpoint_keeps_the_batch_norm_buffers(setup, tmp_path):
    _, batch, rbatch, weights = setup
    model = _loaded(weights)
    model.train()
    _program_loss(model, batch, torch.Generator().manual_seed(SEED))
    buffers = dict(model.named_buffers())
    assert any(not torch.equal(b, torch.zeros_like(b))
               for n, b in buffers.items() if n.endswith("running_mean"))
    ck = Checkpointer(tmp_path, async_writes=False)
    ck.save_latest({"model": model.state_dict()}, 0)
    again = _model()
    again.load_state_dict(ck.restore("latest")[0]["model"])
    for n, b in again.named_buffers():
        assert torch.equal(b, buffers[n]), n
    model.eval()
    again.eval()
    with torch.no_grad():
        assert torch.equal(model(batch), again(batch))


def _dm_from_file(tmp_path, graphs) -> DataModule:
    from graph_hscn_tpu_torch.data.batching import PadBudget
    path = tmp_path / "peptides_func.npz"
    if not path.exists():
        np.savez(path, node_feat=np.concatenate([g.x for g in graphs]))
    return DataModule(graphs=list(graphs), split_idx={},
                      budget=PadBudget.for_dataset(graphs, 2), batch_size=2,
                      num_features=9, num_classes=10, task_level="graph",
                      source=str(path))


def test_eigen_stats_are_kept_beside_the_dataset_file(tmp_path):
    """A second read of the same file under the same settings takes the
    kept stats, bit for bit the computed ones; another setting, or other
    bytes in the file, keeps a file of its own."""
    raw = ts.make_peptides_func(num_graphs=4, seed=3, mean_nodes=12.0)
    pe = PEConfig(encoder="lappe", model="DeepSet", dim_pe=4, layers=2,
                  post_layers=0, eigen_max_freqs=FREQS,
                  eigen_laplacian_norm="none")
    log = Logger(metric_name="ap", quiet=True)
    first = _dm_from_file(tmp_path, raw)
    posenc.posenc_stats(first, pe, log)
    path = posenc.cache_path(first.source, pe)
    assert path.exists()
    second = _dm_from_file(tmp_path, raw)
    calls = []
    original = posenc.compute_posenc_stats
    posenc.compute_posenc_stats = lambda *a, **k: calls.append(1)
    try:
        posenc.posenc_stats(second, pe, log)
    finally:
        posenc.compute_posenc_stats = original
    assert not calls
    for a, b in zip(first.graphs, second.graphs):
        for f in ("eigvecs", "eigvals"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    other = dataclasses.replace(pe, eigen_max_freqs=8)
    assert posenc.cache_path(first.source, other) != path
    np.savez(first.source, node_feat=np.zeros(3))
    assert posenc.cache_path(first.source, pe) != path


def test_the_attention_pairs_are_counted_once_at_set_up(setup):
    """``fit_device`` of a small GraphGPS on the CPU counts a train
    epoch's pairs once, before its first epoch: the train graphs' squared
    node counts as real pairs and, as computed ones, every pair of the
    epoch's slot blocks (2 rows of 2 slots); a model without attention
    counts nothing."""
    from graph_hscn_tpu_torch.models.mpnn import MPNN
    from graph_hscn_tpu_torch.train.loop import fit_device
    from graph_hscn_tpu_torch.utils import profiling
    graphs, batch, _, _ = setup
    cfg = _cfg()
    cfg.training.metric = "mae"       # a split of one graph has no AP
    log = Logger(metric_name="ap", quiet=True)
    profiling.reset_spans()
    fit_device(_model(), graphs[:3], graphs[3:4], graphs[4:], 2, cfg.optim,
               cfg.training, log, "cpu")
    assert profiling.counter_totals() == {
        ("gps.attn.pairs_real", None): sum(g.num_nodes ** 2
                                           for g in graphs[:3]),
        ("gps.attn.pairs_computed", None): 2 * 2 * batch.slot ** 2}
    profiling.reset_spans()
    gcn = MPNN("gcn", "relu", 9, 8, 10, 1, generator=torch.Generator())
    fit_device(gcn, graphs[:3], graphs[3:4], graphs[4:], 2, cfg.optim,
               cfg.training, log, "cpu")
    assert profiling.counter_totals() == {}
