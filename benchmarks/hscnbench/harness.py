"""One run of a cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result line."""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import math
import sys
import time
import types

import numpy as np
import torch

from graph_hscn_tpu_torch import runner
from graph_hscn_tpu_torch.config.config import parse_config

from hscnbench import check, datasets, manifest
from hscnbench.probe import Probe
from hscnbench.ranks import Ranks
from hscnbench.reference import (Dropout, as_dtype, follow, half_batch,
                                 lr_schedule, make_batch, make_weights,
                                 matmul_precision)
from hscnbench.trace import Trace
from hscnbench.window import BenchLogger, StopFit, Window

GIB = 2 ** 30
# Modules that may not be loaded once the window has closed, by top-level
# name compared whole (the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "graph_hscn_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


@contextlib.contextmanager
def npz_read_once():
    """``data/lrgb.py:try_load`` indexes the ``.npz`` once a graph, and
    numpy reads the whole array at each index: at 15,535 graphs that is
    quadratic.  Within the block ``np.load`` of an ``.npz`` hands back
    its arrays read once, so the port's loader runs as it is."""
    original = np.load

    def load(path, *args, **kwargs):
        if str(path).endswith(".npz"):
            with original(path, *args, **kwargs) as z:
                return {k: z[k] for k in z.files}
        return original(path, *args, **kwargs)
    np.load = load
    try:
        yield
    finally:
        np.load = original


@dataclasses.dataclass
class Ctx:
    """What a route and a metric reader see of the run."""
    cell: manifest.Cell
    cfg: object
    device: torch.device
    dtype: object
    logger: BenchLogger
    window: Window
    arrays: dict
    split: dict
    seed: int
    slot: int | None = None
    ranks: Ranks | None = None
    host_next_s: float = 0.0        # in next() of the train batches, window
    window_steps: int = 0           # train batches drawn in the window
    slice_steps: int = 0            # ... and in the traced slice
    slice_batches: list = dataclasses.field(default_factory=list)
    slice_eval_batches: list = dataclasses.field(default_factory=list)
    trace: Trace | None = None
    dims: dict = dataclasses.field(default_factory=dict)
    # The port's kernel wrappers' launch counters over the traced slice.
    slice_launches: dict = dataclasses.field(default_factory=dict)

    def count_launches(self, phase: str) -> None:
        from graph_hscn_tpu_torch.train.capture import counted_kernels
        now = {k.__name__: k.launches for k in counted_kernels()}
        if phase == "start":
            self.slice_launches = now
        else:
            self.slice_launches = {n: v - self.slice_launches[n]
                                   for n, v in now.items()}

    def batches(self, it):
        """The train batches of an epoch of the host loop, counted, timed
        in ``next()`` while the window is open, and their shapes kept in
        the traced slice."""
        it = iter(it)
        w = self.window
        while True:
            t = time.perf_counter()
            if w.tracing:
                with Window.marker("batch_next"):
                    batch = next(it, None)
            else:
                batch = next(it, None)
            dt = time.perf_counter() - t
            if batch is None:
                return
            if w.is_open:
                self.host_next_s += dt
                self.window_steps += 1
            elif w.tracing:
                self.slice_steps += 1
                self.slice_batches.append(shape(batch))
            yield batch

    def eval_batches(self, batches: list):
        """An eval split's batches, each pass over them kept by its shapes
        in the traced slice."""
        ctx = self

        class Kept:
            def __iter__(self):
                for batch in batches:
                    if ctx.window.tracing:
                        ctx.slice_eval_batches.append(shape(batch))
                    yield batch

            def __len__(self):
                return len(batches)
        return Kept()


def shape(batch) -> tuple:
    """(padded rows, real nodes, real edges) of a host batch."""
    return (int(batch.node_feat.shape[0]), int(batch.node_mask.sum()),
            int(batch.edge_mask.sum()))


@contextlib.contextmanager
def data_seam(ctx):
    """The fit's data, as ``runner._run`` makes it, seen by the benchmark
    within the block: ``runner._data`` (the entry every route takes to its
    ``DataModule``) wrapped so that the dataset file is read through
    :func:`npz_read_once`, the route the runner will take is checked
    against the cell's (``routes/<route>.py:takes``), the device slot is
    kept for the reference, the host loop's train batches are counted and
    timed (``Ctx.batches``) and its eval batches' shapes kept in the traced
    slice (``Ctx.eval_batches``).  Nothing else of the run is replaced."""
    original = runner._data
    route = ctx.cell.route

    def data(cfg, device, logger):
        with npz_read_once():
            dm = original(cfg, device, logger)
        if not route.takes(cfg, dm):
            raise RuntimeError(f"the runner would not take the "
                               f"{ctx.cell.workload['route']!r} route for "
                               "this configuration")
        ctx.slot = route.slot(dm)
        train_batches, eval_batches = dm.train_batches, dm.eval_batches

        def timed(epoch_seed=None):
            return ctx.batches(train_batches(epoch_seed=epoch_seed))
        dm.train_batches = timed
        dm.eval_batches = lambda split: ctx.eval_batches(eval_batches(split))
        return dm
    runner._data = data
    try:
        yield
    finally:
        runner._data = original


def run_program(ctx) -> None:
    """The port's own run of the configuration (``runner._run``, the
    dispatch of ``run_experiment``) under the benchmark's logger."""
    with data_seam(ctx):
        runner._run(ctx.cfg, ctx.device, ctx.dtype, ctx.logger,
                    step_timing=False)


def build_config(cell: manifest.Cell, seed: int, data_dir):
    """The configuration as run: the configuration file's, the workload's
    route keys over it (``overrides``: {section: {key: value}}), the
    dataset file's directory and the seed (weights, dropout, shuffle)."""
    raw = copy.deepcopy(cell.config["run"])
    for section, keys in cell.workload.get("overrides", {}).items():
        raw.setdefault(section, {}).update(keys)
    raw["data"]["data_dir"] = str(data_dir)
    raw["data"]["seed"] = seed
    raw["training"]["seed"] = seed
    return parse_config(raw)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_program(name: str, seed: int, seconds: float, trace: bool,
                  device: str | None = None,
                  data_override: dict | None = None,
                  stop_after: int | None = None,
                  cell: manifest.Cell | None = None):
    """Set-up and the fit through the window (and the traced slice);
    with ``stop_after`` the fit ends at that epoch's end instead, for the
    readings of correctness alone.  ``cell``: the cell as loaded, for a
    test's own manifest (default: ``name`` in ``BENCHMARK.json``).
    Returns (ctx, probe, weights)."""
    if seed < 0:
        raise ValueError("--seed is a whole number >= 0")
    cell = cell or manifest.load_cell(name)
    data_spec = {**cell.workload["data"], **(data_override or {})}
    data_dir = datasets.ensure_dataset(data_spec)
    arrays = datasets.load_arrays(data_dir, data_spec["dataset_name"])
    cfg = build_config(cell, seed, data_dir)
    ranks = Ranks.join(device)
    dev, dtype = runner._setup_run(cfg, ranks.device if ranks else device)
    dims = {"features": int(arrays["node_feat"].shape[1]),
            "classes": int(arrays["y"].shape[1]) if "y" in arrays
            else int(arrays["num_node_classes"])}
    if "edge_feat" in arrays:
        dims["edge_features"] = int(arrays["edge_feat"].shape[1])
    ref = cell.reference
    spec = ref.targets(cell.config, dims)
    weights = {t: make_weights(s, seed + i, dev, initial_rule(ref, t))
               for i, (t, s) in enumerate(sorted(spec.items()))}
    probe = Probe({t: program_names(cell.route, w)
                   for t, w in weights.items()},
                  observe=ref.observed, steps=observe_steps(cell),
                  followed=(ref.observed,) + tuple(getattr(ref, "stages", {})),
                  watch=getattr(ref, "watched", ()))
    window = Window(seconds, cell.workload["warmup_epochs"],
                    cfg.training.eval_period,
                    trace_epochs=cell.workload["trace_epochs"] if trace
                    else 0, sync=lambda: sync(dev), stop_after=stop_after,
                    agree=ranks.agree if ranks else None)
    window.listeners.append(probe.epoch_end)
    window.on_open.append(probe.remove)
    logger = BenchLogger(window, cfg.training.metric)
    split = {k: arrays[f"split_{k}"] for k in ("train", "val", "test")}
    ctx = Ctx(cell=cell, cfg=cfg, device=dev, dtype=dtype, logger=logger,
              window=window, arrays=arrays, split=split, seed=seed, dims=dims,
              ranks=ranks)
    window.on_trace.append(ctx.count_launches)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        run_program(ctx)
    except StopFit:
        pass
    else:
        raise RuntimeError("the fit ended before the window closed")
    finally:
        probe.remove()
        logger.finish()
    sync(dev)
    return ctx, probe, weights


def initial_rule(ref, target: str):
    """The reference module's ``initial`` for ``target``'s tensors, as
    ``make_weights`` takes it (None without the hook)."""
    initial = getattr(ref, "initial", None)
    if initial is None:
        return None
    return lambda name, shape: initial(target, name, shape)


def observe_steps(cell) -> int:
    """How many first train steps of each followed model are read: the
    workload's ``observe_steps`` (on a captured route the first eager and
    the replays after it), else 3."""
    return int(cell.workload.get("observe_steps", 3))


def program_names(route, weights: dict, back: bool = False) -> dict:
    """The reference's parameter names as the route's model has them
    (``PARAM_NAMES``: (reference prefix, program prefix) pairs), or with
    ``back`` the other way."""
    pairs = getattr(route, "PARAM_NAMES", ())
    out = {}
    for n, w in weights.items():
        for a, b in pairs:
            a, b = (b, a) if back else (a, b)
            if n.startswith(a):
                n = b + n[len(a):]
                break
        out[n] = w
    return out


def free_program(dev) -> None:
    """Drop what the finished fit left, before the reference runs."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str | None = None,
             data_override: dict | None = None,
             cell: manifest.Cell | None = None) -> dict:
    """The result line of one run.  ``device``, ``data_override`` and
    ``cell`` are for the CPU tests alone (a small dataset on the CPU)."""
    ctx, probe, weights = train_program(name, seed, seconds, trace, device,
                                        data_override, cell=cell)
    cell, window, dev, ranks = ctx.cell, ctx.window, ctx.device, ctx.ranks
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise RuntimeError("loaded by the time the window closed: "
                           + ", ".join(found))
    n_train = len(ctx.split["train"])
    metrics = {
        "train_graphs_per_s": window.epochs * n_train / window.wall_s,
        "peak_mem_gib": memory_peak / GIB,
        "setup_s": window.t_open - t_start,
    }
    busy = None
    if trace:
        ctx.trace = Trace.from_profiler(window.profiler, window.t_trace)
        window.profiler = None
        busy = ctx.trace.busy_s()
        if cell.route.steps_per_epoch(ctx) is not None:
            ctx.slice_steps = (cell.workload["trace_epochs"]
                               * cell.route.steps_per_epoch(ctx))
    if ranks:
        # The fullest card's peak; the busy time averaged over the cards;
        # rank 0 alone goes on to the reference and the result.
        memory_peak = int(ranks.max(memory_peak))
        metrics["peak_mem_gib"] = memory_peak / GIB
        if trace:
            busy = ranks.mean(busy)
        ranks.leave()
        if ranks.rank != 0:
            return None
    free_program(dev)
    numbers = correctness_numbers(ctx, probe, weights)
    correct, checks = check.verdict(numbers, cell.workload["limits"])
    attempted = window.epochs * n_train
    result = {"correct": correct, "attempted": attempted,
              "failed": 0 if correct else attempted}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = {}
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"]).read(ctx)
            if v is not None:
                values[m["name"]] = v
    else:
        values = {m["name"]: metrics[m["name"]] for m in cell.end_to_end}
    result["metrics"] = {k: {"value": v, "unit": units[k]}
                         for k, v in values.items()}
    result["device"] = device_info(dev, cell.chips, memory_peak)
    if trace:
        result["device"].update(busy_s=busy, window_s=ctx.trace.wall_s)
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["checks"] = {n: {k: (v if math.isfinite(v) else repr(v))
                            for k, v in c.items()}
                        for n, c in checks.items()}
    return result


def device_info(dev, chips: int, memory_peak: int) -> dict:
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": chips, "memory_peak_bytes": int(memory_peak)}
    if dev.type == "cuda":
        info["power_limit_w"] = power_limit()
    return info


def power_limit() -> str | None:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def stage(ctx, target: str):
    """(a module with the target's ``forward`` and ``loss``, its steps'
    batches in epoch ``e`` as ``order(e)``): the observed model's from the
    configuration's reference and the route's ``train_order``, a further
    trained model's from the reference's ``stages`` and the route's
    ``stage_order``."""
    ref, route = ctx.cell.reference, ctx.cell.route
    if target == ref.observed:
        return ref, lambda e: route.train_order(ctx, e)
    forward, loss = ref.stages[target]
    return (types.SimpleNamespace(forward=forward, loss=loss),
            lambda e: route.stage_order(ctx, target, e))


def reference_run(ctx, weights: dict, tf32: bool, observe: int,
                  target: str | None = None, half: bool = False,
                  frozen: bool = False,
                  dtype=torch.float32) -> tuple[dict, list]:
    """The reference's first ``observe`` steps of ``target`` (default: the
    observed model, then through its epoch 0) from ``weights`` (TF32 as
    asked), over the batches the route works out again.  The observed
    model's optimizer clips and schedules its lr as the configuration
    parsed by the port says (``optim``), over the horizon the fit gives
    its schedule (``training.epochs`` x epoch 0's train steps); a further
    trained model's (the SCN's) does neither, as the port's clustering.
    For the readings alone: a planted fault (``half``: half of each batch
    left out, the mean taken over the rest; ``frozen``: no update), or
    float64 (``dtype``)."""
    ref = ctx.cell.reference
    target = target or ref.observed
    model, order_of = stage(ctx, target)
    whole = target == ref.observed
    order = order_of(0)
    epoch0_steps = len(order)
    epoch_steps, epoch = (epoch0_steps if whole else None), 1
    while len(order) < observe:
        order = order + order_of(epoch)
        epoch += 1
    if not whole:
        order = order[:observe]
    batches = [make_batch(ctx.arrays, ids, rows, n_pad, ctx.device)
               for ids, rows, n_pad in order]
    init = weights[target]
    if dtype != torch.float32:
        init = {n: w.to(dtype) for n, w in init.items()}
        batches = [as_dtype(b, dtype) for b in batches]
    mp = ctx.cell.config["run"].get("mp", {})
    rate = (float(mp.get("dropout", 0.0))
            if whole and getattr(ctx.cell.route, "DROPOUT", True) else 0.0)
    drop = Dropout(rate, int(mp.get("hidden_channels", 0)), ctx.seed,
                   ctx.device)
    optim = ctx.cfg.optim
    schedule = (lr_schedule(optim.lr, optim.schedule, optim.warmup_steps,
                            ctx.cfg.training.epochs * epoch0_steps)
                if whole else None)
    with matmul_precision(tf32):
        out = follow(model, ctx.cell.config, init, batches, drop, observe,
                     epoch_steps,
                     loss_fn=half_batch(model.loss) if half else None,
                     frozen=frozen, clip=whole and optim.clip_grad_norm,
                     schedule=schedule)
    return out, batches


def program_readings(ctx, probe, batches) -> dict:
    """What the probe read of the program, its logits cut to the real rows
    in the reference's order."""
    level = "node" if batches[0].node_y is not None else "graph"
    logits = []
    if getattr(ctx.cell.route, "OBSERVES_ROWS", True):
        for z, b in zip(probe.logits, batches):
            logits.append(z[b.rows] if level == "node"
                          else z[:b.num_graphs])

    def names(d):
        return program_names(ctx.cell.route, d, back=True)
    obs = ctx.cell.reference.observed
    return {"logits": logits, "first_grad": names(probe.first_grad[obs]),
            "after_step": [names(a) for a in probe.after_step[obs]],
            "after_epoch": names(
                probe.after_epoch0[ctx.cell.reference.observed]),
            "epoch_loss": probe.epoch0_loss}


def batch_gap(probe, batches) -> float:
    """The observed steps' inputs: the real nodes' features against the
    reference's, and the number of real nodes."""
    worst = 0.0
    for pb, rb in zip(probe.batches, batches):
        if int(pb.node_mask.sum()) != rb.x.shape[0]:
            return math.inf
        if not bool(pb.node_mask[rb.rows].all()):
            return math.inf
        worst = max(worst, float((pb.node_feat[rb.rows] - rb.x).abs().max()))
    return worst


def followed_others(ctx) -> list:
    """The trained models followed besides the observed one."""
    return sorted(getattr(ctx.cell.reference, "stages", {}))


def correctness_numbers(ctx, probe, weights) -> dict:
    """The numbers ``correct`` compares.  A model whose first steps were
    not all seen (``observe_steps``: the eager ones and the replays)
    reads inf on the numbers of its steps."""
    ref = ctx.cell.reference
    k = observe_steps(ctx.cell)
    if len(probe.after_step[ref.observed]) < k or probe.epoch0_loss is None:
        return {"steps_observed": float(len(
            probe.after_step[ref.observed]))}
    ref_out, batches = reference_run(ctx, weights, tf32=False, observe=k)
    prog = program_readings(ctx, probe, batches)
    numbers = check.compare(prog, ref_out, weights[ref.observed])
    if getattr(ctx.cell.route, "OBSERVES_ROWS", True):
        numbers["batch"] = batch_gap(probe, batches)
    for t in followed_others(ctx):
        if len(probe.after_step[t]) < k:
            numbers.update({f"{t}.grad_gap": math.inf,
                            f"{t}.step_change_gap": math.inf})
            continue
        out, _ = reference_run(ctx, weights, tf32=False, observe=k,
                               target=t)
        numbers.update(prefixed(t, check.compare_steps(
            {"first_grad": probe.first_grad[t],
             "after_step": probe.after_step[t]}, out, weights[t])))
    extra = getattr(ref, "extra_checks", None)
    if extra is not None:
        numbers.update(extra(probe, batches[0], weights))
    return check.finite(numbers)


def prefixed(target: str, nums: dict) -> dict:
    return {f"{target}.{n}": v for n, v in nums.items()}


def readings(name: str, seed: int, device: str | None = None,
             data_override: dict | None = None) -> dict:
    """The numbers ``correct`` compares, for one seed, read five ways: the
    program against the reference ("sound"); the control (the reference
    in TF32 against the reference); two planted faults against the
    reference (half of each batch left out; no update: a state left
    unchanged); and, as a witness of what float32 rounding does over the
    epoch, the float32 reference against a float64 one ("float64").  The
    program trains through its warm-up epochs alone."""
    cell = manifest.load_cell(name)
    ctx, probe, weights = train_program(
        name, seed, 0.0, False, device, data_override,
        stop_after=cell.workload["warmup_epochs"] - 1, cell=cell)
    if ctx.ranks:
        ctx.ranks.leave()
        if ctx.ranks.rank != 0:
            return None
    free_program(ctx.device)
    out = {"sound": correctness_numbers(ctx, probe, weights)}
    k = observe_steps(cell)
    observed = cell.reference.observed
    init = weights[observed]
    ref, batches = reference_run(ctx, weights, tf32=False, observe=k)
    refs = {t: reference_run(ctx, weights, tf32=False, observe=k,
                             target=t)[0] for t in followed_others(ctx)}
    kinds = {"control": {"tf32": True}, "half_batch": {"half": True},
             "state_unchanged": {"frozen": True}}
    for kind, kw in kinds.items():
        kw = {"tf32": False, **kw}
        other, _ = reference_run(ctx, weights, observe=k, **kw)
        nums = check.compare(other, ref, init)
        for t, rt in refs.items():
            o, _ = reference_run(ctx, weights, observe=k, target=t, **kw)
            nums.update(prefixed(t, check.compare_steps(o, rt, weights[t])))
        extra = getattr(cell.reference, "extra_checks_control", None)
        if extra is not None and kind == "control":
            nums.update(extra(probe, batches[0], weights))
        out[kind] = check.finite(nums)
    truth, _ = reference_run(ctx, weights, tf32=False, observe=k,
                             dtype=torch.float64)
    out["float64"] = check.compare(
        ref, truth, {n: w.double() for n, w in init.items()})
    for t, rt in refs.items():
        tt, _ = reference_run(ctx, weights, tf32=False, observe=k, target=t,
                              dtype=torch.float64)
        out["float64"].update(prefixed(t, check.compare_steps(
            rt, tt, {n: w.double() for n, w in weights[t].items()})))
    return out
