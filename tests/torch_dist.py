"""Run a function of this module on D gloo ranks, one process each, for
the port's mesh tests (tests/test_torch_edge_partition.py,
tests/test_torch_sharded_*.py, tests/test_torch_data_parallel.py,
tests/test_torch_hybrid.py and tests/test_torch_profiling.py); its
:func:`poisoned` data also serves chip_smoke.py's ``debug_nans`` phase.

    outs = spawn("sharded_model", world=4, args={...}, tmp=tmp_path)

Each rank is ``python tests/torch_dist.py <function> <rank> <world>
<dir>``: one torch thread, a gloo group on a ``FileStore`` in ``dir``,
``<function>(rank, world, **args)`` (the arguments pickled by the parent),
its returned dict pickled back.  The parent waits at most ``timeout``
seconds, then kills every rank and fails.  This module imports torch and
the port only, never JAX: the ranks do not load it.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def spawn(fn: str, world: int, args: dict, tmp: Path,
          timeout: float = 120.0) -> list[dict]:
    """``fn(rank, world, **args)`` on ``world`` gloo ranks; returns each
    rank's result, in rank order."""
    tmp = Path(tmp) / f"{fn}-{world}"
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, fn, str(rank), str(world), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{fn} on {world} ranks: no end within "
                             f"{timeout} s")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{fn} rank {rank} of {world} exited "
                                 f"{p.returncode}:\n{log[-4000:]}")
    outs = []
    for rank in range(world):
        with open(tmp / f"out{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _main() -> None:
    import torch.distributed as dist
    fn, rank, world, tmp = (sys.argv[1], int(sys.argv[2]),
                            int(sys.argv[3]), Path(sys.argv[4]))
    torch.set_num_threads(1)
    with open(tmp / "args.pkl", "rb") as f:
        args = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), world), rank=rank, world_size=world)
    try:
        out = globals()[fn](rank, world, **args)
    finally:
        dist.destroy_process_group()
    with open(tmp / f"out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


# ---- the ranks' functions (torch and the port only) ----

def _mesh(rank: int, world: int):
    import torch.distributed as dist

    from graph_hscn_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(("data",), (world,), "cpu")
    assert (mesh.rank, mesh.world_size) == (rank, dist.get_world_size())
    return mesh


def spmm_programs(rank: int, world: int, x, senders, receivers, edge_mask):
    """The three sharded SpMM programs on this rank's block of ``x``."""
    from graph_hscn_tpu_torch.parallel import edge_partition as ep
    n = x.shape[0]
    plan = ep.plan_halo_exchange(senders, receivers, edge_mask, n, world)
    t = {k: torch.from_numpy(np.asarray(v[rank])).long()
         if v.dtype != bool else torch.from_numpy(v[rank])
         for k, v in plan.items() if isinstance(v, np.ndarray)}
    xb = torch.from_numpy(ep.rank_block(x, rank, world))
    snd_d, rcv_d, m_d, _, _ = ep.partition_edges_by_receiver(
        senders, receivers, edge_mask, n, world)
    send = t["send_idx"].reshape(-1)
    return {
        "v1": ep.make_sharded_spmm()(
            xb, torch.from_numpy(snd_d[rank]).long(),
            torch.from_numpy(rcv_d[rank]).long(),
            torch.from_numpy(m_d[rank])).numpy(),
        "v2": ep.make_sharded_spmm_halo()(
            xb, send, t["snd_remap"], t["rcv_local"], t["mask"]).numpy(),
        "v3": ep.make_sharded_spmm_overlap()(
            xb, send, t["snd_loc"], t["rcv_loc"], t["mask_loc"],
            t["snd_hal"], t["rcv_hal"], t["mask_hal"]).numpy(),
    }


def build(conv: str, dims, heads: int, state: dict, dtype=None,
          dropout: float = 0.0, tile: int | None = None, **kwargs):
    """The port's sharded ``conv`` from ``state`` (``kwargs`` to
    ``build_sharded_model``; ``tile``: the GPS's key tile)."""
    from graph_hscn_tpu_torch.parallel.sharded_gcn import build_sharded_model
    model = build_sharded_model(conv, dims, heads=heads, dtype=dtype,
                                dropout=dropout, **kwargs)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    if tile is not None:
        model.tile = tile
    return model


def _arrays(batch: dict) -> tuple[list, dict]:
    """``partition_arrays``' positional arrays of a batch, and its edge
    features and graph ids where the batch has them."""
    arrays = [batch[k] for k in ("senders", "receivers", "edge_mask",
                                 "node_feat", "node_y", "node_mask")]
    return arrays, {"edge_feat": batch.get("edge_feat"),
                    "node_graph": batch.get("node_graph")}


def _grads(model) -> dict:
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


def sharded_model(rank: int, world: int, conv: str, dims, heads: int,
                  state: dict, batch: dict, steps: int = 5,
                  lr: float = 0.01, weight_decay: float = 5e-4,
                  bf16: bool = False, reorder_check: bool = False,
                  backend: str = "auto", plain_grads: bool = False,
                  build_kwargs: dict | None = None) -> dict:
    """The sharded ``conv`` on this rank's block of ``batch`` from the
    weights ``state`` (JAX's, converted; ``build_kwargs`` to
    :func:`build`): the logits block with the kernels' route (the
    local-edge CsrPlan, the kernels' plain versions here; ``backend`` the
    spmm backend, "pallas" to force the route where the layer asks
    ``kernel_enabled``) and without it, the summed loss and gradients
    (``plain_grads``: also without the plan), and ``steps`` AdamW
    full-batch steps (their losses and the final weights); with ``bf16``
    the bfloat16 logits and gradients' finiteness; with ``reorder_check``
    the logits block of the locality-reordered batch.  The batch's edge
    features and graph ids go with it where it has them."""
    from graph_hscn_tpu_torch.ops import spmm
    from graph_hscn_tpu_torch.parallel.sharded_gcn import (
        gather_logits, loss_and_grads, partition_arrays)
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer

    previous = spmm.get_backend()
    spmm.set_backend(backend)
    try:
        build_kwargs = build_kwargs or {}
        mesh = _mesh(rank, world)
        arrays, extra = _arrays(batch)
        planned = partition_arrays(*arrays, mesh, reorder=False,
                                   use_plan=True, **extra).block
        plain = partition_arrays(*arrays, mesh, reorder=False, **extra).block
        model = build(conv, dims, heads, state, **build_kwargs)
        out = {"logits_plan": gather_logits(model, planned).numpy(),
               "logits_plain": gather_logits(model, plain).numpy()}
        model.train()
        if plain_grads:
            out["loss_plain"] = float(loss_and_grads(model, plain))
            out["grads_plain"] = _grads(model)
        out["loss"] = float(loss_and_grads(model, planned))
        out["grads"] = _grads(model)
        opt = build_optimizer(model.parameters(), "adamW", lr, weight_decay)
        out.update(_steps(model, opt, lambda: loss_and_grads(model, planned),
                          steps))
        if bf16:
            m16 = build(conv, dims, heads, state, dtype=torch.bfloat16,
                        **build_kwargs)
            out["logits_bf16"] = gather_logits(m16, planned).numpy()
            m16.train()
            loss16 = loss_and_grads(m16, planned)
            out["bf16_finite"] = bool(torch.isfinite(loss16)) and all(
                bool(p.grad.isfinite().all()) for p in m16.parameters())
        if reorder_check:
            split = partition_arrays(*arrays, mesh, reorder=True,
                                     use_plan=True, **extra)
            out["logits_reordered"] = gather_logits(
                build(conv, dims, heads, state, **build_kwargs),
                split.block).numpy()
            out["perm"] = split.perm
        return out
    finally:
        spmm.set_backend(previous)


def _steps(model, opt, step, steps: int) -> dict:
    """``steps`` of ``step()`` (a loss and gradients) and ``opt.step``:
    their losses and the final weights."""
    losses = []
    for _ in range(steps):
        losses.append(float(step()))
        opt.step()
    return {"step_losses": losses,
            "final": {k: v.detach().numpy().copy()
                      for k, v in model.state_dict().items()}}


def sharded_scn(rank: int, world: int, mp_units, clusters: int, state: dict,
                batch: dict, steps: int = 3, lr: float = 0.01,
                weight_decay: float = 5e-4) -> dict:
    """The sharded SCN on this rank's block from ``state``, with the
    local-edge CsrPlan (``csr_spmm``'s plain version here, where a layer's
    input is 64 wide or more) and without: the two losses, the summed
    gradients of their sum, the assignments of every row (all-gathered);
    ``steps`` AdamW steps with the plan."""
    from graph_hscn_tpu_torch.parallel.edge_partition import all_gather_rows
    from graph_hscn_tpu_torch.parallel.sharded_gcn import partition_arrays
    from graph_hscn_tpu_torch.parallel.sharded_scn import (
        ShardedSCN, scn_loss_and_grads)
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer

    mesh = _mesh(rank, world)
    arrays, _ = _arrays(batch)
    model = ShardedSCN(arrays[3].shape[1], mp_units, clusters)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    out = {}
    for route in ("plain", "plan"):
        blk = partition_arrays(*arrays, mesh, reorder=False,
                               use_plan=route == "plan", outdeg=True).block
        with torch.no_grad():
            mc, o = model.losses(blk)
        out[route] = {"mc": float(mc), "o": float(o),
                      "loss": float(scn_loss_and_grads(model, blk)),
                      "grads": _grads(model),
                      "assign": all_gather_rows(model.assign(blk)[:, None],
                                                blk.group)[:, 0].numpy()}
    opt = build_optimizer(model.parameters(), "adamW", lr, weight_decay)
    out.update(_steps(model, opt, lambda: scn_loss_and_grads(model, blk),
                      steps))
    return out


def sharded_hscn(rank: int, world: int, state: dict, batch: dict,
                 clusters, model_kwargs: dict, steps: int = 3,
                 lr: float = 0.01, weight_decay: float = 5e-4) -> dict:
    """The sharded HSCN (``model_kwargs`` to ``ShardedHSCN`` after the
    input width) on this rank's block with the cluster ids ``clusters``
    [N]: the logits with the local-edge CsrPlan (csr_spmm's plain
    version here) and without, the summed loss and gradients and
    ``steps`` AdamW steps."""
    from graph_hscn_tpu_torch.parallel.edge_partition import rank_block
    from graph_hscn_tpu_torch.parallel.sharded_gcn import (
        gather_logits, loss_and_grads, partition_arrays)
    from graph_hscn_tpu_torch.parallel.sharded_hscn import ShardedHSCN
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer

    mesh = _mesh(rank, world)
    arrays, _ = _arrays(batch)
    planned = partition_arrays(*arrays, mesh, reorder=False,
                               use_plan=True).block
    plain = partition_arrays(*arrays, mesh, reorder=False).block
    clust = torch.from_numpy(rank_block(clusters.astype(np.int64), rank,
                                        world))
    model = ShardedHSCN(arrays[3].shape[1], **model_kwargs)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    out = {"logits_plan": gather_logits(model, planned, clust).numpy(),
           "logits_plain": gather_logits(model, plain, clust).numpy()}
    model.train()
    out["loss"] = float(loss_and_grads(model, planned, clust))
    out["grads"] = _grads(model)
    opt = build_optimizer(model.parameters(), "adamW", lr, weight_decay)
    out.update(_steps(model, opt,
                      lambda: loss_and_grads(model, planned, clust), steps))
    return out


def mincut_contractions(rank: int, world: int, s, x, senders, receivers,
                        edge_mask) -> dict:
    """``make_sharded_mincut_contractions`` on this rank's blocks."""
    from graph_hscn_tpu_torch.parallel import edge_partition as ep
    n = s.shape[0]
    snd, rcv, m, _, _ = ep.partition_edges_by_receiver(
        senders, receivers, edge_mask, n, world)
    stx, stas = ep.make_sharded_mincut_contractions()(
        torch.from_numpy(ep.rank_block(s, rank, world)),
        torch.from_numpy(ep.rank_block(x, rank, world)),
        torch.from_numpy(snd[rank]).long(), torch.from_numpy(rcv[rank]).long(),
        torch.from_numpy(m[rank]))
    return {"stx": stx.numpy(), "stas": stas.numpy()}


def use_init(state: dict, setattr=setattr) -> None:
    """The port's fits start from ``state`` (a state_dict of numpy
    arrays: JAX's init, converted; for the HSCN pipeline {"scn": ...,
    "hscn": ...}; for the MPNN {"mpnn": ...}): ``setattr`` replaces
    ``sharded_gcn.build_sharded_model`` (and the hybrid's reference to
    it), ``sharded_scn.ShardedSCN`` and ``.ShardedHSCN``, or the runner's
    ``build_mpnn`` (pass pytest's ``monkeypatch.setattr`` to have them
    restored)."""
    from graph_hscn_tpu_torch import runner
    from graph_hscn_tpu_torch.parallel import hybrid as phy
    from graph_hscn_tpu_torch.parallel import sharded_gcn as psg
    from graph_hscn_tpu_torch.parallel import sharded_scn as pss

    def loading(real, weights):
        def build(*args, **kwargs):
            model = real(*args, **kwargs)
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in weights.items()})
            return model
        return build

    if set(state) == {"scn", "hscn"}:
        setattr(pss, "ShardedSCN", loading(pss.ShardedSCN, state["scn"]))
        setattr(pss, "ShardedHSCN", loading(pss.ShardedHSCN, state["hscn"]))
    elif set(state) == {"mpnn"}:
        setattr(runner, "build_mpnn", loading(runner.build_mpnn,
                                              state["mpnn"]))
    else:
        build = loading(psg.build_sharded_model, state)
        setattr(psg, "build_sharded_model", build)
        setattr(phy, "build_sharded_model", build)


def run_cli(rank: int, world: int, raw: dict, predict: str,
            state: dict | None = None) -> dict:
    """``run_experiment`` then ``run_eval("best", predict_out=predict)``
    of the raw config on the CPU over this group (from ``state`` where
    given, :func:`use_init`): the history, the best val loss, the eval
    results, the plans and the train steps."""
    from graph_hscn_tpu_torch.config.config import parse_config
    from graph_hscn_tpu_torch.runner import run_eval, run_experiment
    if state is not None:
        use_init(state)
    cfg = parse_config(raw)
    result = run_experiment(cfg, device="cpu")
    evals = run_eval(cfg, "best", device="cpu", predict_out=predict)
    return {"history": result.history, "best": result.best_val_loss,
            "eval": evals, "partition": result.partition,
            "steps": result.num_train_steps}


def _no_step():
    """An optimizer that leaves the weights and their gradients as they
    are (the gradients are read after the step)."""
    import types
    return types.SimpleNamespace(step=lambda *a: None, minibatches=0)


def build_model(kind: str, kwargs: dict, state: dict):
    """The port's ``MPNN`` or ``GatedGCNNet`` (``kwargs``) from ``state``."""
    from graph_hscn_tpu_torch.models.gatedgcn import GatedGCNNet
    from graph_hscn_tpu_torch.models.mpnn import MPNN
    model = {"mpnn": MPNN, "gatedgcn": GatedGCNNet}[kind](**kwargs)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def dp_cases(rank: int, world: int, cases: dict, steps: int = 3,
             lr: float = 0.01, weight_decay: float = 5e-4) -> dict:
    """Each case ({name: {"kind", "kwargs", "state", "graphs", "budget",
    "slot", "plan", "loss_fn", "node_level", "eval"}}) on this rank: its
    sub-batch of ``parallel/data_parallel.py:pack_for_devices``, the DP
    train step's loss and summed gradients, ``steps`` AdamW DP steps
    (their losses and the final weights), with "eval" the DP eval step's
    loss; on rank 0 also the single-device step (train/loop.py) on the
    concatenated batch.  "plan": the CSR plan and the kernels' route
    (their plain versions here)."""
    from graph_hscn_tpu_torch.data.batching import PadBudget, pack_batch
    from graph_hscn_tpu_torch.ops import spmm
    from graph_hscn_tpu_torch.parallel import data_parallel as dp
    from graph_hscn_tpu_torch.train.loop import make_train_step
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer

    mesh = _mesh(rank, world)
    previous = spmm.get_backend()
    out = {}
    try:
        for name, c in cases.items():
            spmm.set_backend("pallas" if c["plan"] else "xla")
            sub = dp.pack_for_devices(c["graphs"], world, c["budget"],
                                      c["slot"], c["plan"],
                                      ranks=[rank])[0].to("cpu")
            model = build_model(c["kind"], c["kwargs"], c["state"])
            params = dict(model.named_parameters())
            step = dp.make_dp_train_step(model, _no_step(), c["loss_fn"],
                                         mesh, c["node_level"])
            loss, _, _, mask = step(sub, 0)
            res = {"loss": float(loss), "rows": int(mask.sum()),
                   "grads": {k: p.grad.numpy().copy()
                             for k, p in params.items()}}
            if c.get("eval"):
                res["eval_loss"] = float(dp.make_dp_eval_step(
                    model, c["loss_fn"], mesh, c["node_level"])(sub)[0])
            opt = build_optimizer(model.parameters(), "adamW", lr,
                                  weight_decay)
            step = dp.make_dp_train_step(model, opt, c["loss_fn"], mesh,
                                         c["node_level"])
            res["step_losses"] = [float(step(sub, i)[0])
                                  for i in range(steps)]
            res["final"] = {k: v.detach().numpy().copy()
                            for k, v in model.state_dict().items()}
            if rank == 0:
                b = c["budget"]
                one = pack_batch(c["graphs"], PadBudget(
                    b.num_nodes * world, b.num_edges * world,
                    b.num_graphs * world), with_spmm_plan=c["plan"],
                    slot_nodes=c["slot"]).to("cpu")
                single = build_model(c["kind"], c["kwargs"], c["state"])
                train_step, _ = make_train_step(
                    single, _ZeroGrad(single), c["loss_fn"], c["node_level"])
                res["single_loss"] = float(train_step(one)[0])
                res["single_grads"] = {
                    k: (torch.zeros_like(p) if p.grad is None
                        else p.grad).numpy().copy()
                    for k, p in single.named_parameters()}
            out[name] = res
    finally:
        spmm.set_backend(previous)
    return out


def hybrid_cases(rank: int, world: int, shape, graphs, cases: dict,
                 steps: int = 3, lr: float = 0.01, weight_decay: float = 5e-4,
                 cli: dict | None = None) -> dict:
    """Each case ({name: {"conv", "dims", "heads", "state", "hidden"}}) on
    this rank of a 2-D mesh of ``shape``: the port's
    ``build_hybrid_split`` of ``graphs`` and this rank's block
    (``hybrid_block``), the sharded model from ``state``: its logits of
    every rank (the kernels' route, their plain versions here, and the
    plain one), the loss and gradients summed over every rank, ``steps``
    AdamW steps; then with ``cli`` (:func:`run_cli`'s arguments) the CLI
    run."""
    from graph_hscn_tpu_torch.ops import spmm
    from graph_hscn_tpu_torch.parallel.hybrid import (build_hybrid_split,
                                                      hybrid_block)
    from graph_hscn_tpu_torch.parallel.mesh import make_mesh
    from graph_hscn_tpu_torch.parallel.sharded_gcn import (
        gather_logits, loss_and_grads)
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer

    mesh = make_mesh(("data", "model"), tuple(shape), "cpu")
    assert mesh.coords == (rank // shape[1], rank % shape[1])
    split = build_hybrid_split(graphs, *shape)
    out = {}
    previous = spmm.get_backend()
    spmm.set_backend("pallas")
    try:
        for name, c in cases.items():
            gps = c["conv"] == "gps"
            planned = hybrid_block(*split[:4], mesh, use_plan=not gps,
                                   graph_ids=gps)
            plain = hybrid_block(*split[:4], mesh, graph_ids=gps)
            model = build(c["conv"], c["dims"], c["heads"], c["state"],
                          hidden=c.get("hidden"))
            res = {"logits_plan": gather_logits(model, planned).numpy(),
                   "logits_plain": gather_logits(model, plain).numpy()}
            model.train()
            res["loss"] = float(loss_and_grads(model, planned))
            res["grads"] = _grads(model)
            opt = build_optimizer(model.parameters(), "adamW", lr,
                                  weight_decay)
            res.update(_steps(model, opt,
                              lambda: loss_and_grads(model, planned), steps))
            out[name] = res
    finally:
        spmm.set_backend(previous)
    if cli is not None:
        out["cli"] = run_cli(rank, world, **cli)
    return out


@contextlib.contextmanager
def poisoned(pipeline, mode: str):
    """Within the block, ``pipeline.DataModule.from_config`` (the data
    pipeline module of either package) puts a NaN into ``x[0, 0]`` of
    every graph (``mode`` "all") or of graph 1 alone ("one"); "clean"
    leaves the data as it is."""
    cls = pipeline.DataModule
    real = cls.__dict__["from_config"]

    def from_config(klass, *args, **kwargs):
        dm = real.__func__(klass, *args, **kwargs)
        for g in {"all": dm.graphs, "one": dm.graphs[1:2],
                  "clean": []}[mode]:
            g.x[0, 0] = np.nan
        return dm

    cls.from_config = classmethod(from_config)
    try:
        yield
    finally:
        cls.from_config = real


def nan_run(rank: int, world: int, runs: list[dict]) -> list[dict]:
    """``run_experiment`` on this group of each of ``runs`` ({"raw", "mode",
    "nans"}), in order, with ``runtime.debug_nans`` as "nans" says (the
    guard reset first, as in a fresh process) and the data ``poisoned`` as
    "mode" says: each {"raised": the FloatingPointError's message, or
    None; "losses": the epochs' losses of a run that raised nothing}."""
    from graph_hscn_tpu_torch.config.config import parse_config
    from graph_hscn_tpu_torch.data import pipeline
    from graph_hscn_tpu_torch.runner import run_experiment
    from graph_hscn_tpu_torch.utils.profiling import nan_guard
    out = []
    for run in runs:
        cfg = parse_config(run["raw"])
        cfg.runtime.debug_nans = run["nans"]
        nan_guard(False)
        with poisoned(pipeline, run["mode"]):
            try:
                result = run_experiment(cfg, device="cpu")
            except FloatingPointError as e:
                out.append({"raised": str(e)})
                continue
        out.append({"raised": None, "losses": [
            (h["train_loss"], h.get("validation_loss"), h.get("test_loss"))
            for h in result.history]})
    return out


def dryrun(rank: int, world: int) -> dict:
    """``parallel/dryrun.py:dryrun_multichip`` on this rank (CPU)."""
    from graph_hscn_tpu_torch.parallel.dryrun import dryrun_multichip
    return dryrun_multichip("cpu")


class _ZeroGrad:
    """The train loop's optimizer interface, stepping nothing."""

    def __init__(self, model):
        self.model = model

    def zero_grad(self):
        self.model.zero_grad(set_to_none=True)

    def step(self, applies=None):
        pass


if __name__ == "__main__":
    _main()
