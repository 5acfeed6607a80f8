"""The parent's side of the port's edge-partition tests
(tests/test_torch_sharded_gcn.py, tests/test_torch_sharded_gat.py,
tests/test_torch_edge_partition.py): a VOC-superpixels batch packed by the
JAX package, JAX's init of the sharded GCN, GIN and GAT and its
``make_sharded_*`` programs at D devices of the CPU mesh (forward,
``value_and_grad``, AdamW steps), their outputs named as the port's
parameters (``models/convert.py``); and the checks that hold the port's
ranks (``tests/torch_dist.py``) against them."""

from __future__ import annotations

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch.distributed as dist
import yaml

import torch_dist
from graph_hscn_tpu.config.config import parse_config as jax_parse_config

from graph_hscn_tpu.data.batching import PadBudget, pack_batch
from graph_hscn_tpu.data.synthetic import make_voc_superpixels
from graph_hscn_tpu.parallel import sharded_gcn as jsg
from graph_hscn_tpu.parallel.edge_partition import plan_halo_exchange
from graph_hscn_tpu.parallel.mesh import make_mesh
from graph_hscn_tpu.runner import run_experiment as jax_run_experiment
from graph_hscn_tpu.train.optimizers import build_optimizer
from graph_hscn_tpu_torch.config.config import parse_config
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.convert import (sharded_gat_params_from_jax,
                                                 sharded_gcn_params_from_jax,
                                                 sharded_gin_params_from_jax)

BATCH_KEYS = ("senders", "receivers", "edge_mask", "node_feat", "node_y",
              "node_mask")
CONVERT = {"gcn": sharded_gcn_params_from_jax,
           "gin": sharded_gin_params_from_jax,
           "gat": sharded_gat_params_from_jax}
MAKE = {"gcn": jsg.make_sharded_gcn, "gin": jsg.make_sharded_gin,
        "gat": jsg.make_sharded_gat}


def voc_batch(D: int, num_graphs: int = 4, seed: int = 99,
              mean_nodes: float = 300) -> dict:
    """JAX's packed batch of synthetic VOC graphs, rows a multiple of D*8
    (the sharded tests' batch), as numpy arrays."""
    graphs = make_voc_superpixels(num_graphs=num_graphs, seed=seed,
                                  mean_nodes=mean_nodes)
    b = pack_batch(graphs, PadBudget.for_dataset(
        graphs, batch_size=num_graphs, node_multiple=D * 8))
    return {k: np.asarray(getattr(b, k)) for k in BATCH_KEYS}


def init(conv: str, dims, heads: int = 1, seed: int = 0):
    key = jax.random.PRNGKey(seed)
    if conv == "gat":
        return jsg.init_sharded_gat_params(key, dims, heads=heads)
    return {"gcn": jsg.init_sharded_gcn_params,
            "gin": jsg.init_sharded_gin_params}[conv](key, dims)


def as_port(conv: str, params) -> dict:
    """JAX params (or grads) -> the port's state_dict, as numpy."""
    return {k: v.numpy() for k, v in CONVERT[conv](
        jax.tree_util.tree_map(np.asarray, params)).items()}


def reference(conv: str, D: int, params, batch: dict, steps: int = 5,
              lr: float = 0.01, weight_decay: float = 5e-4, **make) -> dict:
    """JAX's sharded ``conv`` at D devices from ``params``: logits [N, C],
    loss and grads, ``steps`` AdamW steps' losses and final params (port
    names)."""
    mesh = make_mesh(("data",), (D,), devices=jax.devices()[:D])
    n = batch["node_feat"].shape[0]
    plan_np = plan_halo_exchange(batch["senders"], batch["receivers"],
                                 batch["edge_mask"], n, D)
    plan = {k: jnp.asarray(v) for k, v in plan_np.items()
            if k not in ("block_size", "halo_width", "eidx_loc",
                         "eidx_hal")}
    forward, vg = MAKE[conv](mesh, num_layers=len(params), **make)
    xb, yb, okb = jsg.shard_node_blocks(mesh, D, batch["node_feat"],
                                        batch["node_y"], batch["node_mask"])
    out = {"logits": np.asarray(forward(params, xb, plan)).reshape(n, -1)}
    loss, grads = vg(params, xb, plan, yb, okb)
    out["loss"], out["grads"] = float(loss), as_port(conv, grads)
    tx = build_optimizer("adamW", lr, weight_decay)
    opt_state = tx.init(params)

    @jax.jit
    def apply(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    losses = []
    for _ in range(steps):
        loss, grads = vg(params, xb, plan, yb, okb)
        params, opt_state = apply(params, opt_state, grads)
        losses.append(float(loss))
    out["step_losses"], out["final"] = losses, as_port(conv, params)
    out["plan"] = plan_np
    return out


def run_ranks(fn: str, D: int, args: dict, tmp_path) -> list[dict]:
    """``torch_dist.<fn>`` on D gloo ranks: in this process for D = 1 (a
    1-rank group made and destroyed here), spawned otherwise."""
    if D > 1:
        return torch_dist.spawn(fn, D, args, tmp_path)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store1"), 1), rank=0, world_size=1)
    try:
        return [getattr(torch_dist, fn)(0, 1, **args)]
    finally:
        dist.destroy_process_group()


def check_against_jax(conv: str, D: int, dims, tmp_path, heads: int = 1,
                      **extra) -> dict:
    """The port's sharded ``conv`` at D ranks (``torch_dist.sharded_model``)
    against JAX's at D devices from the same init on the same batch:
    logits (both routes) within 1e-5 relative (atol 1e-6 * max|ref|), the
    loss within 1e-5 relative, gradients within 1e-4 * max|ref|, 5 AdamW
    steps' losses within 1e-4 relative and the final weights within 1e-4
    * max|ref|, every rank ending with the same weights.  Returns rank 0's
    output, with JAX's (``ref``) and the batch."""
    batch = voc_batch(D)
    params = init(conv, dims, heads)
    ref = reference(conv, D, params, batch)
    outs = run_ranks("sharded_model", D, dict(
        conv=conv, dims=dims, heads=heads, state=as_port(conv, params),
        batch=batch, **extra), tmp_path)
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
        for name, w in ref["final"].items():
            err = np.abs(out["final"][name] - w).max()
            assert err <= 1e-4 * np.abs(w).max(), (name, err)
    for out in outs[1:]:
        for name, w in outs[0]["final"].items():
            np.testing.assert_array_equal(out["final"][name], w)
    outs[0]["ref"], outs[0]["batch"] = ref, batch
    return outs[0]


def shrunk(path: Path, conv: str | None = None, **changes) -> dict:
    """The shipped edge-partition config ``path`` at mesh.shape [1], 24
    graphs, 3 epochs with an eval every epoch (``changes``:
    {"section.field": value} on top), as a raw dict both packages
    parse."""
    raw = yaml.safe_load(Path(path).read_text())
    raw["data"]["num_graphs"] = 24
    raw["mesh"]["shape"] = [1]
    raw["training"].update(max_epochs=3, eval_period=1)
    if conv is not None:
        raw["mp"]["conv_type"] = conv
    for key, value in changes.items():
        section, field = key.split(".")
        raw.setdefault(section, {})[field] = value
    return raw


def init_state(raw: dict) -> dict:
    """JAX's init of the config's sharded model (``training.seed``), as
    the port's state_dict."""
    cfg = parse_config(raw)
    dm = DataModule.from_config(cfg.data)
    conv = cfg.mpnn.conv_type.lower()
    dims = ([dm.num_features]
            + [cfg.mpnn.hidden_channels] * (cfg.mpnn.num_layers - 1)
            + [dm.num_classes])
    return as_port(conv, init(conv, dims, cfg.mpnn.num_heads,
                              cfg.training.seed))


def follow_jax(raw: dict, D: int, tmp_path, monkeypatch) -> dict:
    """The port's run_experiment then run_eval("best") with the predict
    export (``torch_dist.run_cli``) of ``raw`` at D ranks from JAX's init,
    against JAX's run_experiment at D devices: per-epoch train, val and
    test losses within 1e-4 relative; run_eval's val loss equal to the
    fit's best (rtol 1e-5, atol 1e-6); the export's rows real, finite.
    Returns rank 0's output."""
    raw = copy.deepcopy(raw)
    raw["mesh"]["shape"] = [D]
    raw["training"].update(checkpoint_dir=str(tmp_path / "ck"),
                           checkpoint_every=1)
    state = init_state(raw)
    predict = str(tmp_path / "preds.npz")
    if D > 1:
        outs = torch_dist.spawn("run_cli", D, dict(
            raw=raw, predict=predict, state=state), tmp_path)
    else:
        torch_dist.use_init(state, monkeypatch.setattr)
        outs = [torch_dist.run_cli(0, 1, raw, predict)]
    jax_raw = copy.deepcopy(raw)
    jax_raw["training"].pop("checkpoint_dir")
    ref = jax_run_experiment(jax_parse_config(jax_raw))
    for out in outs:
        assert len(out["history"]) == len(ref.history) == 3
        for got, want in zip(out["history"], ref.history):
            for key in ("train_loss", "validation_loss", "test_loss"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                           err_msg=key)
        np.testing.assert_allclose(out["eval"]["val"]["loss"], out["best"],
                                   rtol=1e-5, atol=1e-6)
    z = np.load(predict)
    for split in ("val", "test"):
        rows = outs[0]["partition"][split]["rows"]
        assert z[f"{split}_scores"].shape[1] == 21
        assert z[f"{split}_scores"].shape == z[f"{split}_targets"].shape
        assert 0 < z[f"{split}_scores"].shape[0] < rows
        assert np.isfinite(z[f"{split}_scores"]).all()
    return outs[0]
