"""The parent's side of the port's mesh tests
(tests/test_torch_sharded_*.py, tests/test_torch_edge_partition.py,
tests/test_torch_data_parallel.py, tests/test_torch_hybrid.py): a
VOC-superpixels batch packed by the JAX package (with edge features and
graph ids where asked), JAX's init of the sharded GCN, GIN, GAT,
GatedGCN, GPS, SCN and HSCN and its ``make_sharded_*`` programs at D
devices of the CPU mesh (forward, ``value_and_grad``, AdamW steps), their
outputs named as the port's parameters (``models/convert.py``); and the
checks that hold the port's ranks (``tests/torch_dist.py``) against
them; JAX's data-parallel step (:func:`dp_reference`) and hybrid programs
(:func:`hybrid_reference`) at a mesh of the CPU's devices."""

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
from graph_hscn_tpu.parallel import sharded_gatedgcn as jsgg
from graph_hscn_tpu.parallel import sharded_gcn as jsg
from graph_hscn_tpu.parallel import sharded_gps as jsgps
from graph_hscn_tpu.parallel import sharded_hscn as jsh
from graph_hscn_tpu.parallel import sharded_scn as jss
from graph_hscn_tpu.parallel.edge_partition import (plan_halo_exchange,
                                                    shard_arrays)
from graph_hscn_tpu.parallel.mesh import make_mesh
from graph_hscn_tpu.runner import run_experiment as jax_run_experiment
from graph_hscn_tpu.train.optimizers import build_optimizer
from graph_hscn_tpu_torch.config.config import parse_config
from graph_hscn_tpu_torch.data.pipeline import DataModule
from graph_hscn_tpu_torch.models.convert import (
    sharded_gat_params_from_jax, sharded_gatedgcn_params_from_jax,
    sharded_gcn_params_from_jax, sharded_gin_params_from_jax,
    sharded_gps_params_from_jax, sharded_hscn_params_from_jax,
    sharded_scn_params_from_jax)

BATCH_KEYS = ("senders", "receivers", "edge_mask", "node_feat", "node_y",
              "node_mask")
CONVERT = {"gcn": sharded_gcn_params_from_jax,
           "gin": sharded_gin_params_from_jax,
           "gat": sharded_gat_params_from_jax,
           "gatedgcn": sharded_gatedgcn_params_from_jax,
           "gps": sharded_gps_params_from_jax,
           "scn": sharded_scn_params_from_jax,
           "hscn": sharded_hscn_params_from_jax}
MAKE = {"gcn": jsg.make_sharded_gcn, "gin": jsg.make_sharded_gin,
        "gat": jsg.make_sharded_gat}


def voc_batch(D: int, num_graphs: int = 4, seed: int = 99,
              mean_nodes: float = 300, edge_features: int = 0) -> dict:
    """JAX's packed batch of synthetic VOC graphs, rows a multiple of D*8
    (the sharded tests' batch), as numpy arrays, with the graph ids
    (``node_graph``) and, given ``edge_features``, that many normal edge
    features (``edge_feat``, as tests/test_sharded_gatedgcn.py:64 draws
    them)."""
    graphs = make_voc_superpixels(num_graphs=num_graphs, seed=seed,
                                  mean_nodes=mean_nodes)
    if edge_features:
        rng = np.random.default_rng(seed)
        graphs = [g.replace(edge_attr=rng.normal(size=(
            g.edge_index.shape[1], edge_features)).astype(np.float32))
            for g in graphs]
    b = pack_batch(graphs, PadBudget.for_dataset(
        graphs, batch_size=num_graphs, node_multiple=D * 8))
    out = {k: np.asarray(getattr(b, k)) for k in BATCH_KEYS}
    out["node_graph"] = np.asarray(b.node_graph)
    if edge_features:
        out["edge_feat"] = np.asarray(b.edge_feat)
    return out


def init(conv: str, dims, heads: int = 1, seed: int = 0,
         edge_features: int | None = None, local_conv: str = "gcn",
         hidden: int | None = None):
    """JAX's init of the sharded ``conv`` over ``dims`` (GatedGCN and GPS:
    ``len(dims) - 1`` layers ``hidden`` wide, by default ``dims[1]``)."""
    key = jax.random.PRNGKey(seed)
    hidden = hidden or dims[1]
    if conv == "gat":
        return jsg.init_sharded_gat_params(key, dims, heads=heads)
    if conv == "gatedgcn":
        return jsgg.init_sharded_gatedgcn_params(
            key, dims[0], edge_features, hidden, dims[-1], len(dims) - 1)
    if conv == "gps":
        return jsgps.init_sharded_gps_params(
            key, dims[0], hidden, dims[-1], len(dims) - 1, heads,
            local_conv=local_conv, edge_features=edge_features)
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
    mesh, plan_np, plan = _mesh_plan(D, batch)
    n = batch["node_feat"].shape[0]
    xb, yb, okb, gidb = jsg.shard_node_blocks(
        mesh, D, batch["node_feat"], batch["node_y"], batch["node_mask"],
        batch["node_graph"].astype(np.int32))
    el = eh = None
    if "edge_feat" in batch:
        el, eh = shard_arrays(mesh, *jsgg.gather_edge_groups(
            batch["edge_feat"], plan_np))
    if conv == "gatedgcn":
        fw, vg_g = jsgg.make_sharded_gatedgcn(mesh, len(params["layers"]),
                                              **make)

        def forward(params, xb, plan):
            return fw(params, xb, el, eh, okb, plan)

        def vg(params, xb, plan, yb, okb):
            return vg_g(params, xb, el, eh, okb, plan, yb)
    elif conv == "gps":
        if el is not None:
            plan.update(e_loc=el, e_hal=eh)
        fw, vg_g = jsgps.make_sharded_gps(mesh, len(params["layers"]),
                                          **make)

        def forward(params, xb, plan):
            return fw(params, xb, gidb, okb, plan)

        def vg(params, xb, plan, yb, okb):
            return vg_g(params, xb, gidb, okb, plan, yb)
    else:
        forward, vg = MAKE[conv](mesh, num_layers=len(params), **make)
    out = {"logits": np.asarray(forward(params, xb, plan)).reshape(n, -1)}
    loss, grads = vg(params, xb, plan, yb, okb)
    out["loss"], out["grads"] = float(loss), as_port(conv, grads)
    out.update(adam_steps(conv, lambda p: vg(p, xb, plan, yb, okb), params,
                          steps, lr, weight_decay))
    out["plan"] = plan_np
    return out


def adam_steps(conv: str, vg, params, steps: int, lr: float = 0.01,
               weight_decay: float = 5e-4) -> dict:
    """``steps`` AdamW steps of JAX's ``vg(params) -> (loss, grads)``:
    their losses and the final params (port names)."""
    tx = build_optimizer("adamW", lr, weight_decay)
    opt_state = tx.init(params)

    @jax.jit
    def apply(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    losses = []
    for _ in range(steps):
        loss, grads = vg(params)
        params, opt_state = apply(params, opt_state, grads)
        losses.append(float(loss))
    return {"step_losses": losses, "final": as_port(conv, params)}


def _mesh_plan(D: int, batch: dict):
    """JAX's D-device mesh, the batch's halo plan (host and device)."""
    mesh = make_mesh(("data",), (D,), devices=jax.devices()[:D])
    plan_np = plan_halo_exchange(batch["senders"], batch["receivers"],
                                 batch["edge_mask"],
                                 batch["node_feat"].shape[0], D)
    plan = {k: jnp.asarray(v) for k, v in plan_np.items()
            if k not in ("block_size", "halo_width", "eidx_loc",
                         "eidx_hal")}
    return mesh, plan_np, plan


def scn_reference(D: int, params, batch: dict, clusters: int,
                  steps: int = 3) -> dict:
    """JAX's ``make_sharded_scn`` at D devices from ``params``: the two
    losses, ``value_and_grad``, the assignments [N] and ``steps`` AdamW
    steps (the plain program: JAX's Pallas route is a TPU kernel)."""
    mesh, _, plan = _mesh_plan(D, batch)
    n = batch["node_feat"].shape[0]
    outdeg = np.bincount(batch["senders"][batch["edge_mask"]],
                         minlength=n).astype(np.float32)
    xb, okb, db = jsg.shard_node_blocks(mesh, D, batch["node_feat"],
                                        batch["node_mask"], outdeg)
    losses, vg, assign = jss.make_sharded_scn(mesh, clusters)
    mc, o = losses(params, xb, okb, db, plan)
    loss, grads = vg(params, xb, okb, db, plan)
    out = {"mc": float(mc), "o": float(o), "loss": float(loss),
           "grads": as_port("scn", grads),
           "assign": np.asarray(assign(params, xb, okb, db,
                                       plan)).reshape(-1)}
    out.update(adam_steps("scn", lambda p: vg(p, xb, okb, db, plan), params,
                          steps))
    return out


def hscn_reference(D: int, params, batch: dict, clusters: np.ndarray,
                   num_clusters: int, steps: int = 3, **make) -> dict:
    """JAX's ``make_sharded_hscn`` (``make``: vv_pattern, heads) at D
    devices from ``params`` with the cluster ids ``clusters`` [N]: logits
    [N, C], loss and grads, ``steps`` AdamW steps."""
    mesh, _, plan = _mesh_plan(D, batch)
    n = batch["node_feat"].shape[0]
    xb, okb, cb, yb = jsg.shard_node_blocks(
        mesh, D, batch["node_feat"], batch["node_mask"],
        clusters.astype(np.int32), batch["node_y"])
    forward, vg = jsh.make_sharded_hscn(mesh, num_clusters, **make)
    out = {"logits": np.asarray(forward(params, xb, okb, cb,
                                        plan)).reshape(n, -1)}
    loss, grads = vg(params, xb, okb, cb, plan, yb, okb)
    out["loss"], out["grads"] = float(loss), as_port("hscn", grads)
    out.update(adam_steps("hscn",
                          lambda p: vg(p, xb, okb, cb, plan, yb, okb),
                          params, steps))
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
                      batch: dict | None = None, init_kwargs=None,
                      make=None, adam_outliers: bool = False,
                      exact_zero: tuple = (), **extra) -> dict:
    """The port's sharded ``conv`` at D ranks (``torch_dist.sharded_model``
    with ``extra``) against JAX's at D devices from the same init
    (``init_kwargs`` to :func:`init`; ``make`` to JAX's program) on the
    same batch (default ``voc_batch(D)``): logits (both routes) within
    1e-5 relative (atol 1e-6 * max|ref|), the loss within 1e-5 relative,
    gradients within 1e-4 * max|ref| (without the plan too where the
    ranks give them), AdamW steps' losses (``steps``, default 5) within
    1e-4 relative and the
    final weights within 1e-4 * max|ref|, every rank ending with the same
    weights (``adam_outliers``: :func:`assert_post_adam`).  The parameters
    named in ``exact_zero`` (GPS's key biases) have a gradient that is
    zero in exact arithmetic: it is held within 1e-4 times the largest
    gradient of all, and the weights Adam moves by that rounding alone
    within the sum of the lrs, not to each other (tests/test_torch_gps.py's
    criterion).  Returns rank 0's output, with JAX's (``ref``) and the
    batch."""
    batch = voc_batch(D) if batch is None else batch
    params = init(conv, dims, heads, **(init_kwargs or {}))
    ref = reference(conv, D, params, batch, steps=extra.get("steps", 5),
                    **(make or {}))
    outs = run_ranks("sharded_model", D, dict(
        conv=conv, dims=dims, heads=heads, state=as_port(conv, params),
        batch=batch, **extra), tmp_path)
    scale = np.abs(ref["logits"]).max()
    for out in outs:
        for key in ("logits_plan", "logits_plain"):
            np.testing.assert_allclose(out[key], ref["logits"], rtol=1e-5,
                                       atol=1e-6 * scale, err_msg=key)
        np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5)
        top = max(np.abs(g).max() for g in ref["grads"].values())
        for key in ("grads", "grads_plain"):
            for name, g in ref["grads"].items() if key in out else ():
                err = np.abs(out[key][name] - g).max()
                g_max = top if name.endswith(exact_zero) else np.abs(g).max()
                assert err <= 1e-4 * g_max, (key, name, err)
        np.testing.assert_allclose(out["step_losses"], ref["step_losses"],
                                   rtol=1e-4)
        lr_sum = 0.01 * len(ref["step_losses"])
        for name in ref["final"]:
            if name.endswith(exact_zero):
                assert np.abs(out["final"][name]).max() <= lr_sum, name
                assert np.abs(ref["final"][name]).max() <= lr_sum, name
        final = {k: v for k, v in ref["final"].items()
                 if not k.endswith(exact_zero)}
        if adam_outliers:
            assert_post_adam(out["final"], final, as_port(conv, params),
                             lr_sum)
        for name, w in final.items() if not adam_outliers else ():
            err = np.abs(out["final"][name] - w).max()
            assert err <= 1e-4 * np.abs(w).max(), (name, err)
    for out in outs[1:]:
        for name, w in outs[0]["final"].items():
            np.testing.assert_array_equal(out["final"][name], w)
    outs[0]["ref"], outs[0]["batch"] = ref, batch
    return outs[0]


def assert_post_adam(got: dict, ref: dict, init: dict,
                     lr_sum: float) -> None:
    """Weights after AdamW steps from ``init``, held by the size of the
    update: each parameter's error within 2e-3 of the distance JAX's
    weights travelled (L2; plus 1e-6 of the weights' norm, their own
    rounding, for a parameter that weight decay alone moves), every
    element within ``lr_sum``, the sum of the steps' lrs.  Adam divides each gradient element by its own root
    mean square plus eps = 1e-8, so an element whose gradient is near
    eps's size turns its rounding into a step of up to lr, and the later
    steps carry that on: JAX against itself at D = 1 and 2 (the same sums
    in another order) on the GatedGCN batch of
    tests/test_torch_sharded_gatedgcn.py differs by 1.1e-3 of the update
    after 5 steps, dozens of elements past 1e-4 * max|ref|."""
    for name, w in ref.items():
        err = got[name] - w
        moved = float(np.linalg.norm(w - init[name]))
        floor = 1e-6 * float(np.linalg.norm(w))   # the weights' rounding
        assert np.linalg.norm(err) <= 2e-3 * moved + floor, (
            name, float(np.linalg.norm(err)), moved)
        assert np.abs(err).max() <= lr_sum, (name, np.abs(err).max())


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
    if cfg.hscn is not None:
        h, key = cfg.hscn, jax.random.PRNGKey(cfg.training.seed)
        return {"scn": as_port("scn", jss.init_sharded_scn_params(
                    key, dm.num_features, list(h.mp_units), h.num_clusters)),
                "hscn": as_port("hscn", jsh.init_sharded_hscn_params(
                    key, dm.num_features, h.hidden_channels, dm.num_classes,
                    h.num_layers, heads=h.num_heads,
                    virtual_feedback=h.virtual_feedback))}
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


def dp_reference(jmodel, params, graphs, D: int, budget, slot, loss_fn: str,
                 node_level: bool, convert, steps: int = 3, lr: float = 0.01,
                 weight_decay: float = 5e-4, evaluate: bool = False) -> dict:
    """JAX's ``make_dp_train_step`` at D devices of the CPU mesh from
    ``params`` on ``pack_for_devices(graphs, D, budget, slot)``: the loss
    and the summed gradients (one SGD step of lr 1: the weights' change),
    ``steps`` AdamW steps' losses and final weights, with ``evaluate``
    ``make_dp_eval_step``'s loss; gradients and weights as the port's
    state_dict (``convert``)."""
    from graph_hscn_tpu.parallel import data_parallel as jdp
    from graph_hscn_tpu.train.loop import TrainState

    mesh = make_mesh(("data",), (D,), devices=jax.devices()[:D])
    batch = jdp.shard_stacked_batch(
        jdp.pack_for_devices(graphs, D, budget, slot_nodes=slot), mesh)

    def state(tx):
        return TrainState(params=params, opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32),
                          rng=jax.random.PRNGKey(0))

    def port(tree):
        return {k: v.numpy() for k, v in convert(
            jax.tree_util.tree_map(np.asarray, tree)).items()}

    sgd = optax.sgd(1.0)
    moved, loss, *_ = jdp.make_dp_train_step(jmodel, sgd, loss_fn, mesh,
                                             node_level)(state(sgd), batch)
    out = {"loss": float(loss), "grads": port(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a) - np.asarray(b), params, moved.params))}
    if evaluate:
        out["eval_loss"] = float(jdp.make_dp_eval_step(
            jmodel, loss_fn, mesh, node_level)(params, batch)[0])
    tx = build_optimizer("adamW", lr, weight_decay)
    st, step, losses = state(tx), jdp.make_dp_train_step(
        jmodel, tx, loss_fn, mesh, node_level), []
    for _ in range(steps):
        st, loss, *_ = step(st, batch)
        losses.append(float(loss))
    out.update(step_losses=losses, final=port(st.params), init=port(params))
    return out


HYBRID_AXES = ("data", "model")


def hybrid_reference(conv: str, params, graphs, shape, steps: int = 3,
                     heads: int = 1) -> dict:
    """JAX's hybrid program of ``conv`` ("gcn", "gat", "gps") at a 2-D
    mesh of ``shape`` on the CPU's devices from ``params``, on JAX's
    ``build_hybrid_split(graphs)``: logits [Ddp*Dep*Nb, C], the loss and
    gradients (``grad_axes`` both axes), ``steps`` AdamW steps (port
    names)."""
    from graph_hscn_tpu.parallel.hybrid import build_hybrid_split
    d_dp, d_ep = shape
    mesh = make_mesh(HYBRID_AXES, (d_dp, d_ep),
                     devices=jax.devices()[:d_dp * d_ep])
    plan, x, y, ok, _ = build_hybrid_split(graphs, d_dp, d_ep)
    kw = dict(axis="model", shard_axes=HYBRID_AXES, grad_axes=HYBRID_AXES)
    if conv == "gps":
        fw, vg_g = jsgps.make_sharded_gps(mesh, len(params["layers"]),
                                          heads, **kw)
        plan["ok_blocks"] = ok

        def forward(p):
            return fw(p, x, plan["gid_blocks"], ok, plan)

        def vg(p):
            return vg_g(p, x, plan["gid_blocks"], ok, plan, y)
    else:
        fw, vg_g = MAKE[conv](mesh, num_layers=len(params), **kw)

        def forward(p):
            return fw(p, x, plan)

        def vg(p):
            return vg_g(p, x, plan, y, ok)
    logits = np.asarray(forward(params))
    out = {"logits": logits.reshape(-1, logits.shape[-1])}
    loss, grads = vg(params)
    out["loss"], out["grads"] = float(loss), as_port(conv, grads)
    out.update(adam_steps(conv, vg, params, steps))
    return out


def mpnn_init_state(raw: dict) -> dict:
    """JAX's init of the config's MPNN (``training.seed``; the weights
    depend on the input width alone, not on the example batch), as the
    port's state_dict under "mpnn", for ``torch_dist.use_init``."""
    from graph_hscn_tpu.data.pipeline import DataModule as JaxDataModule
    from graph_hscn_tpu.models.mpnn import build_mpnn
    from graph_hscn_tpu.train.loop import init_state as jax_init_state
    from graph_hscn_tpu_torch.models.convert import mpnn_params_from_jax
    cfg = jax_parse_config(copy.deepcopy(raw))
    dm = JaxDataModule.from_config(cfg.data)
    readout = "none" if dm.task_level == "node" else "mean"
    model = build_mpnn(cfg.mpnn, dm.num_features, dm.num_classes,
                       compat=cfg.compat.double_relu, readout=readout)
    example = pack_batch(dm.split("val")[:2], dm.budget)
    params = jax_init_state(model, build_optimizer("adamW", 0.01, 5e-4),
                            example, seed=cfg.training.seed).params
    return {"mpnn": {k: v.numpy() for k, v in mpnn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}}
