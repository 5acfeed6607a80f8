"""The port's hybrid 2-D mesh (graph_hscn_tpu_torch/parallel/hybrid.py:
data-parallel graph groups times edge-partitioned node blocks) against
the JAX package's ``parallel/hybrid.py`` on the same inputs, from JAX's
init carried over (``models/convert.py``).

- ``balance_groups`` and ``build_hybrid_split`` equal to JAX's (every plan
  array, with the halo indices re-strided to the padded width, the
  blocks, the masks and labels).
- GCN and GAT at ``[1, 1]`` (one gloo rank in this process), ``[2, 1]``,
  ``[1, 2]`` and ``[2, 2]`` (gloo ranks, ``tests/torch_dist.py``), and GPS
  at ``[2, 2]``, against JAX's ``make_sharded_gcn`` / ``make_sharded_gat``
  / ``make_sharded_gps`` with ``axis="model"``, ``shard_axes`` and
  ``grad_axes`` both axes: logits within 1e-5 relative (atol 1e-6 *
  max|ref|) on the kernels' route (their plain versions) and the plain
  one, the loss 1e-5 relative, gradients 1e-4 * max|ref|, 3 AdamW steps'
  losses 1e-4 relative and the weights by ``assert_post_adam``, every rank
  ending alike.
- The shrunk ``configs/GCN/voc_superpixels_GCN_hybrid.yaml`` through
  ``run_experiment`` at ``[2, 2]`` follows JAX's per-epoch losses (1e-4
  relative); ``run_eval`` (eval-only) equals the fit's best and writes the
  predict export.  The shipped ``[2, 4]`` raises JAX's ValueError on one
  rank; GPS with the GatedGCN local block raises JAX's ValueError in both
  packages.
- JAX's quirks, copied: the hybrid passes no dropout and no compute
  dtype (a run with ``mp.dropout: 0.5`` and ``compute_dtype: bfloat16``
  trains exactly as one without, in both packages, and the two packages
  agree), its schedule's horizon is the epoch count.
- The port's counterpart of ``__graft_entry__.dryrun_multichip``
  (``parallel/dryrun.py``) on 2 and 4 gloo ranks.
"""

from __future__ import annotations

import copy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

import sharded_jax
import torch_dist
from graph_hscn_tpu.config.config import parse_config as jparse
from graph_hscn_tpu.data.synthetic import make_voc_superpixels as jvoc
from graph_hscn_tpu.parallel import hybrid as jhy
from graph_hscn_tpu.runner import run_experiment as jax_run
from graph_hscn_tpu_torch.config.config import parse_config
from graph_hscn_tpu_torch.data.synthetic import make_voc_superpixels as tvoc
from graph_hscn_tpu_torch.parallel import hybrid as phy
from graph_hscn_tpu_torch.runner import run_eval, run_experiment
from sharded_jax import assert_post_adam, run_ranks

ROOT = Path(__file__).parents[1]
HYBRID = ROOT / "configs" / "GCN" / "voc_superpixels_GCN_hybrid.yaml"
SHAPES = ([1, 1], [2, 1], [1, 2], [2, 2])


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("shape,reorder,num_graphs", [
    ((2, 4), True, 6), ((3, 2), False, 7), ((4, 2), True, 3)],
    ids=["2x4", "3x2-plain", "4x2-empty-group"])
def test_split_equals_jax(shape, reorder, num_graphs):
    """balance_groups and build_hybrid_split array-equal to JAX's (a
    split smaller than Ddp leaves a group empty, fully masked)."""
    kw = dict(num_graphs=num_graphs, seed=11, mean_nodes=150)
    jg, tg = jvoc(**kw), tvoc(**kw)
    assert phy.balance_groups(tg, shape[0]) == jhy.balance_groups(
        jg, shape[0])
    plan, x, y, ok, meta = phy.build_hybrid_split(tg, *shape, reorder)
    jplan, jx, jy, jok, jmeta = jhy.build_hybrid_split(jg, *shape, reorder)
    assert set(jplan) | {"block_size", "halo_width"} == set(plan)
    for key, want in jplan.items():
        np.testing.assert_array_equal(plan[key], np.asarray(want), key)
    for got, want in ((x, jx), (y, jy), (ok, jok)):
        np.testing.assert_array_equal(got, np.asarray(want))
    for key in ("block_size", "halo_width", "groups"):
        assert meta[key] == jmeta[key]
    for key in ("node_y", "node_mask"):
        np.testing.assert_array_equal(meta[key], jmeta[key])
    for got, want in zip(meta["group_edges"], jmeta["group_edges"]):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert plan["block_size"] == meta["block_size"]
    if num_graphs < shape[0]:
        assert not ok.reshape(shape[0], -1)[-1].any()


def _graphs():
    kw = dict(num_graphs=6, seed=11, mean_nodes=120)
    return jvoc(**kw), tvoc(**kw)


CASES = {"gcn": dict(conv="gcn", dims=[14, 64, 21], heads=1),
         "gat": dict(conv="gat", dims=[14, 64, 21], heads=1),
         "gps": dict(conv="gps", dims=[14, 16, 21], heads=4, hidden=16)}


def _hybrid_raw(shape, **changes) -> dict:
    """The shipped hybrid config shrunk: 12 graphs, hidden 16, 3 epochs
    with an eval every epoch, at ``shape``; ``changes``
    {"section.field": value}."""
    raw = yaml.safe_load(HYBRID.read_text())
    raw["data"]["num_graphs"] = 12
    raw["mp"].update(hidden_channels=16, num_layers=3)
    raw["training"].update(max_epochs=3, eval_period=1)
    raw["mesh"]["shape"] = list(shape)
    for key, value in changes.items():
        section, field = key.split(".")
        raw.setdefault(section, {})[field] = value
    return raw


def _follows(history, ref_history, rtol=1e-4):
    assert len(history) == len(ref_history) == 3
    for got, want in zip(history, ref_history):
        for key in ("train_loss", "validation_loss", "test_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                       err_msg=key)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_hybrid_matches_jax(shape, tmp_path):
    """The module docstring's model criteria at ``shape`` (GPS at [2, 2]),
    and at [2, 2] the CLI: run_experiment following JAX's, run_eval of
    the best snapshot with the predict export."""
    jg, tg = _graphs()
    names = ("gcn", "gat", "gps") if shape == [2, 2] else ("gcn", "gat")
    cases, refs = {}, {}
    for name in names:
        c = CASES[name]
        params = sharded_jax.init(c["conv"], c["dims"], c["heads"],
                                  hidden=c.get("hidden"))
        refs[name] = sharded_jax.hybrid_reference(c["conv"], params, jg,
                                                  shape, heads=c["heads"])
        cases[name] = dict(c, state=sharded_jax.as_port(c["conv"], params))
    args = dict(shape=shape, graphs=tg, cases=cases)
    if shape == [2, 2]:
        raw = _hybrid_raw(shape, **{
            "training.checkpoint_dir": str(tmp_path / "ck"),
            "training.checkpoint_every": 1})
        args["cli"] = dict(raw=raw, predict=str(tmp_path / "p.npz"),
                           state=sharded_jax.init_state(raw))
    outs = run_ranks("hybrid_cases", int(np.prod(shape)), args, tmp_path)
    for name, ref in refs.items():
        scale = np.abs(ref["logits"]).max()
        top = max(np.abs(g).max() for g in ref["grads"].values())
        init = cases[name]["state"]
        for out in (o[name] for o in outs):
            for key in ("logits_plan", "logits_plain"):
                np.testing.assert_allclose(out[key], ref["logits"],
                                           rtol=1e-5, atol=1e-6 * scale,
                                           err_msg=(name, key))
            np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5)
            for k, g in ref["grads"].items():
                # GPS's key bias has a zero gradient in exact arithmetic.
                g_max = top if k.endswith("attn.k.bias") else np.abs(g).max()
                err = np.abs(out["grads"][k] - g).max()
                assert err <= 1e-4 * g_max, (name, k, err)
            np.testing.assert_allclose(out["step_losses"],
                                       ref["step_losses"], rtol=1e-4)
            lr_sum = 0.01 * len(ref["step_losses"])
            final = {k: v for k, v in ref["final"].items()
                     if not k.endswith("attn.k.bias")}
            assert_post_adam(out["final"], final, init, lr_sum)
        for out in outs[1:]:
            for k, w in outs[0][name]["final"].items():
                np.testing.assert_array_equal(out[name]["final"][k], w)
    if shape == [2, 2]:
        jraw = copy.deepcopy(args["cli"]["raw"])
        jraw["training"].pop("checkpoint_dir")
        ref = jax_run(jparse(jraw))
        for out in outs:
            cli = out["cli"]
            assert cli["steps"] == 3
            _follows(cli["history"], ref.history)
            np.testing.assert_allclose(cli["eval"]["val"]["loss"],
                                       cli["best"], rtol=1e-5, atol=1e-6)
        z = np.load(tmp_path / "p.npz")
        for split in ("val", "test"):
            assert z[f"{split}_scores"].shape == z[f"{split}_targets"].shape
            assert z[f"{split}_scores"].shape[1] == 21
            assert np.isfinite(z[f"{split}_scores"]).all()


def test_quirks_no_dropout_no_dtype(tmp_path, monkeypatch):
    """JAX's fit_hybrid passes no dropout and no compute dtype: at [1, 1]
    a run with mp.dropout 0.5 and runtime.compute_dtype bfloat16 (and a
    cosine schedule over the epoch count) follows JAX's run of the same
    config within 1e-4, and equals, bit for bit, the port's run with
    dropout 0 in float32."""
    quirky = _hybrid_raw([1, 1], **{
        "mp.dropout": 0.5, "runtime.compute_dtype": "bfloat16",
        "optim.schedule": "cosine", "optim.warmup_steps": 1})
    plain = _hybrid_raw([1, 1], **{
        "mp.dropout": 0.0, "optim.schedule": "cosine",
        "optim.warmup_steps": 1})
    torch_dist.use_init(sharded_jax.init_state(quirky), monkeypatch.setattr)
    got = run_experiment(parse_config(quirky), device="cpu")
    again = run_experiment(parse_config(plain), device="cpu")
    ref = jax_run(jparse(copy.deepcopy(quirky)))
    _follows(got.history, ref.history)
    assert got.history == again.history
    assert not dist.is_initialized()


def test_gps_gatedgcn_local_raises():
    """GPS with the GatedGCN local block on the 2-D mesh raises JAX's
    ValueError, in both packages."""
    raw = _hybrid_raw([1, 1], **{"mp.conv_type": "gps",
                                 "mp.gps_local_conv": "gatedgcn",
                                 "mp.num_heads": 4})
    with pytest.raises(ValueError, match="GCN local block for GPS"):
        run_experiment(parse_config(raw), device="cpu")
    with pytest.raises(ValueError, match="GCN local block for GPS"):
        jax_run(jparse(copy.deepcopy(raw)))
    assert not dist.is_initialized()


def test_shipped_hybrid_config_raises_on_one_rank(tmp_path):
    """The shipped shape [2, 4] asks for 8 devices: on one rank it raises
    JAX's ValueError, in run_experiment and in run_eval."""
    raw = yaml.safe_load(HYBRID.read_text())
    raw["data"]["num_graphs"] = 8
    with pytest.raises(ValueError, match=r"needs 8 devices, have 1"):
        run_experiment(parse_config(raw), device="cpu")
    raw["training"]["checkpoint_dir"] = str(tmp_path / "ck")
    with pytest.raises(ValueError, match=r"needs 8 devices, have 1"):
        run_eval(parse_config(raw), device="cpu")


@pytest.mark.parametrize("world", (2, 4))
def test_dryrun_multichip(world, tmp_path):
    """``parallel/dryrun.py`` on ``world`` gloo ranks: a DP step on an
    HSCN, an edge-partitioned GCN step, a checkpoint round trip under the
    mesh with an eval-only pass, a sharded HSCN and SCN step, a ring GPS
    step (GCN and GatedGCN local) and a hybrid 2-D step: finite losses,
    the same on every rank."""
    outs = torch_dist.spawn("dryrun", world, {}, tmp_path)
    for out in outs:
        assert out.keys() == outs[0].keys()
        for key, value in out.items():
            assert np.isfinite(value), key
            np.testing.assert_allclose(value, outs[0][key], rtol=1e-6,
                                       err_msg=key)
