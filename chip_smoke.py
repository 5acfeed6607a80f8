#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (graph_hscn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero:
  1. device  - the card's name, count, and nvidia-smi's name and power limit.
               Without a CUDA card the script stops here: no CPU fallback.
  2. build   - nvcc builds every kernel from graph_hscn_tpu_torch/csrc/, one
               process per source, all at once; prints seconds and ptxas -v.
  3. kernels - each kernel at the main path's shapes (a real VOC-superpixels
               sparse batch, N=9784 nodes, F=64 and 21, float32 and bfloat16
               inputs) against its plain PyTorch version; CUDA-event times of
               kernel, plain version and one library call, beside the bound.
  4. train   - run_experiment on configs/GCN/voc_superpixels_GCN_sparse.yaml at
               its full width for 2 epochs: finite losses, and the kernels'
               launch counts from that run alone (8 csr_spmm launches a train
               step and 4 an eval batch); a torch.profiler window over
               steady train steps (device busy time, idle share, kernels by
               time); then the full-width model on a small batch, on the
               card and on the CPU, logits and gradients agree.
The last three lines are the {"kernels": [...]} record, nvidia-smi's line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "GCN" / "voc_superpixels_GCN_sparse.yaml"
EPOCHS = 2
# Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, and float32
# operations/s outside the tensor cores (the kernels' FMAs run there).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 100, warmup: int = 20) -> tuple[float, float]:
    """(device ms, host ms) of one call.  Host: wall time of ``iters``
    calls ending in a sync.  Device: CUDA events around ``iters`` calls
    queued behind a device sleep longer than the host needs to enqueue
    them, so the events time back-to-back execution on the card and not
    the host's launch rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~2e6 clock cycles a millisecond at the card's ~2 GHz.
    torch.cuda._sleep(int(1.5 * host_ms * iters * 2e6) + 2_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_ms(fn) -> tuple[float | None, str]:
    """Time one PyTorch library call used as a yardstick; None (with the
    reason) where this PyTorch build does not offer it for these inputs."""
    try:
        return time_ms(fn)[0], ""
    except (RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0]}"


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py drives the port on a CUDA card "
             "and has no CPU fallback")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"[device] {name} x{count}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(f"[device] nvidia-smi: {smi}", flush=True)
    return name, count, smi


def phase_build():
    from graph_hscn_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    results = build.build_all()
    print(f"[build] {len(results)} kernels in "
          f"{time.perf_counter() - t0:.2f} s (sm_90a)", flush=True)
    for r in results:
        print(f"[build] {r.name}: {r.seconds:.2f} s -> {r.path.name}")
        for line in r.log.strip().splitlines():
            print(f"[build]   {line}")


def phase_kernels():
    """Hold each kernel against its plain version at the main path's
    shapes; returns the kernels' records (without launch counts)."""
    import torch

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.ops.cuda.sddmm_kernel import (
        edge_sddmm, edge_sddmm_plain)
    from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import (csr_spmm,
                                                           csr_spmm_plain)
    from graph_hscn_tpu_torch.ops.spmm import gcn_norm_weights

    cfg = load_config(CONFIG)
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    dm.with_spmm_plan = True
    b = next(iter(dm.train_batches(epoch_seed=dm.seed))).to("cuda")
    p = b.spmm
    n, e, nnz = p.num_nodes, p.col.numel(), p.num_edges
    w, _ = gcn_norm_weights(b.senders, b.receivers, b.edge_mask, n)
    w_t = w.index_select(0, p.t_order)
    print(f"[kernels] VOC batch: N={n} E={e} real edges={nnz}", flush=True)

    def csr_tensor(row_ptr, col, vals):
        """The same matrix as a torch CSR tensor, columns sorted within each
        row (what cuSPARSE expects; the product is unchanged)."""
        rows = torch.repeat_interleave(torch.arange(n, device="cuda"),
                                       (row_ptr[1:] - row_ptr[:-1]).long())
        srt = torch.argsort(rows * n + col[:nnz].long())
        return torch.sparse_csr_tensor(row_ptr.long(), col[:nnz].long()[srt],
                                       vals[:nnz][srt], (n, n),
                                       check_invariants=True)

    # Library yardsticks: A, A^T, and A's pattern for the SDDMM.
    a_csr = csr_tensor(p.row_ptr, p.col, w)
    at_csr = csr_tensor(p.t_row_ptr, p.t_col, w_t)
    a_pat = csr_tensor(p.row_ptr, p.col, torch.zeros_like(w))

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    worst = {"csr_spmm": 0.0, "edge_sddmm": 0.0}
    for f in (64, 21):
        g = torch.randn(n, f, device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(n, f, device="cuda", generator=gen).to(dtype)
            xt = x.t().contiguous()
            sz = x.element_size()
            runs = [
                ("csr_spmm", "forward", x,
                 lambda x=x: csr_spmm(x, p.row_ptr, p.col, w),
                 lambda x=x: csr_spmm_plain(x, p.row_ptr, p.col, w),
                 n * f * sz + (n + 1) * 4 + nnz * 8 + n * f * 4,
                 lambda x=x: torch.sparse.mm(a_csr, x)),
                ("edge_sddmm", "dw", x,
                 lambda x=x, g=g: edge_sddmm(x, g, p.row, p.col, nnz),
                 lambda x=x, g=g: edge_sddmm_plain(x, g, p.row, p.col, nnz),
                 n * f * sz + n * f * 4 + nnz * 8 + e * 4,
                 lambda xt=xt, g=g: torch.sparse.sampled_addmm(
                     a_pat, g, xt, beta=0.0)),
            ]
            if dtype == torch.float32:   # the backward's g is float32
                runs.append(
                    ("csr_spmm", "transpose", g,
                     lambda g=g: csr_spmm(g, p.t_row_ptr, p.t_col, w_t),
                     lambda g=g: csr_spmm_plain(g, p.t_row_ptr, p.t_col,
                                                w_t),
                     n * f * 4 + (n + 1) * 4 + nnz * 8 + n * f * 4,
                     lambda g=g: torch.sparse.mm(at_csr, g)))
            for name, role, inp, kern, plain, nbytes, lib in runs:
                out, ref = kern(), plain()
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                tol = 1e-5 * max(float(ref.abs().max()), 1.0)
                if not out.isfinite().all() or err > tol:
                    fail(f"{name} {role} F={f} {dtype}: max |err| {err:.3e} "
                         f"> tolerance {tol:.3e}")
                worst[name] = max(worst[name], err)
                lib_ms, why = (library_ms(lib) if dtype == torch.float32
                               else (None, "float32 only"))
                b_ms, b_by = bound_ms(nbytes, 2.0 * nnz * f)
                k_ms, k_host = time_ms(kern)
                p_ms, p_host = time_ms(plain)
                case = dict(name=name, role=role, f=f,
                            dtype=str(dtype).replace("torch.", ""),
                            max_abs_err=err, tol=tol, ms=k_ms,
                            plain_ms=p_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=b_by)
                cases.append(case)
                print(f"[kernels] {name:10s} {role:9s} F={f:2d} "
                      f"{case['dtype']:8s} err {err:.2e} (tol {tol:.1e}) "
                      f"device: kernel {k_ms * 1e3:7.2f} us  plain "
                      f"{p_ms * 1e3:7.2f} us  library "
                      + (f"{lib_ms * 1e3:7.2f} us" if lib_ms is not None
                         else f"n/a ({why})")
                      + f"  bound {b_ms * 1e3:5.2f} us ({b_by}); host a "
                      f"call: kernel {k_host * 1e3:6.2f} us  plain "
                      f"{p_host * 1e3:6.2f} us", flush=True)
    records = {}
    for c in cases:   # the record of each kernel: F=64 float32, main role
        if (c["f"], c["dtype"]) == (64, "float32") and c["role"] in (
                "forward", "dw"):
            records[c["name"]] = c
    src = "graph_hscn_tpu_torch/csrc/{}.cu"
    return [
        {"name": "csr_spmm", "route": "cuda",
         "source": src.format("csr_spmm"),
         "replaces": "graph_hscn_tpu/ops/pallas/spmm_kernel.py:235",
         **_timing(records["csr_spmm"], worst["csr_spmm"])},
        {"name": "edge_sddmm", "route": "cuda",
         "source": src.format("edge_sddmm"),
         "replaces": "graph_hscn_tpu/ops/pallas/sddmm_kernel.py:32",
         **_timing(records["edge_sddmm"], worst["edge_sddmm"])},
    ]


def _timing(case: dict, worst_err: float) -> dict:
    return {"launches": 0, "max_abs_err": worst_err, "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"]}


def phase_train():
    """The main path: run_experiment on the card, launch counts from that
    run alone.  Returns {kernel: launches}."""
    import torch

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.ops.cuda.sddmm_kernel import edge_sddmm
    from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import csr_spmm
    from graph_hscn_tpu_torch.runner import run_experiment

    cfg = load_config(CONFIG)
    cfg.training.epochs = EPOCHS
    cfg.training.eval_period = 1
    torch.cuda.reset_peak_memory_stats()
    csr_spmm.launches = 0
    edge_sddmm.launches = 0
    t0 = time.perf_counter()
    result = run_experiment(cfg, step_timing=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"csr_spmm": csr_spmm.launches,
                "edge_sddmm": edge_sddmm.launches}
    layers = cfg.mpnn.num_layers
    steps, evals = result.num_train_steps, result.num_eval_batches
    want = 2 * layers * steps + layers * evals
    print(f"[train] {result.epochs_run} epochs, {steps} train steps, "
          f"{evals} eval batches in {wall:.2f} s; launches {launches} "
          f"(csr_spmm expected {want} = 2*{layers}*{steps} + "
          f"{layers}*{evals}; edge_sddmm is off the GCN path: its "
          "weights carry no gradient)", flush=True)
    losses = [v for h in result.history for k, v in h.items()
              if k.endswith("_loss")]
    if not losses or not all(math.isfinite(v) for v in losses):
        fail(f"non-finite or missing losses: {losses}")
    if launches["csr_spmm"] != want:
        fail(f"csr_spmm launched {launches['csr_spmm']} times, want {want}")
    ms = [s * 1e3 for s in result.step_seconds]
    print(f"[train] step ms (synchronised host clock): median "
          f"{statistics.median(ms):.3f}, first {ms[0]:.3f}, min "
          f"{min(ms):.3f}, max {max(ms):.3f}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
    for h in result.history:
        print(f"[train] {h}")
    return launches


def phase_profile(steps: int = 6):
    """Where a train step's time goes: the fit loop's body (move the batch,
    train step) over ``steps`` steady steps of the main path's model and
    batches, under torch.profiler; device busy time, idle share, and the
    kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.models.mpnn import build_mpnn
    from graph_hscn_tpu_torch.train.loop import make_train_step
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer

    cfg = load_config(CONFIG)
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    dm.with_spmm_plan = True
    batches = list(dm.train_batches(epoch_seed=dm.seed))
    model = build_mpnn(cfg.mpnn, dm.num_features, dm.num_classes,
                       readout="none",
                       generator=torch.Generator().manual_seed(0)).cuda()
    opt = build_optimizer(model.parameters(), cfg.optim.optim_type,
                          cfg.optim.lr, cfg.optim.weight_decay)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step, _ = make_train_step(model, opt, cfg.training.loss_fn,
                              node_level=True, generator=gen)
    for b in batches[:3]:   # warm-up
        step(b.to("cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(batches[i % len(batches)].to("cuda"))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device operations: kernels, copies, fills.  User annotations (the
    # optimizer's record_function range) span kernels already counted.
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not dev:
        print("[profile] the profiler recorded no device events: device "
              "busy time not measured", flush=True)
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    print(f"[profile] {steps} train steps (profiler on): wall "
          f"{wall_ms / steps:.3f} ms a step, device busy "
          f"{busy_ms / steps:.3f} ms a step, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {len(dev) / steps:.1f} device "
          "operations a step", flush=True)
    by_name: dict[str, list[float]] = {}
    for e in dev:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
    for name, ts in top:
        print(f"[profile]   {sum(ts) / steps:8.2f} us a step  "
              f"{len(ts) / steps:5.1f} a step  {name[:90]}")


def phase_reference():
    """The full-width model on a 4-graph batch: the card (kernels) against
    the CPU (plain versions), logits and every parameter gradient."""
    import torch

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.data.batching import PadBudget, pack_batch
    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.models.mpnn import build_mpnn
    from graph_hscn_tpu_torch.ops import spmm
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    from graph_hscn_tpu_torch.train.loss import criterion

    cfg = load_config(CONFIG)
    set_matmul_precision(cfg.runtime.matmul_precision)
    dm = DataModule.from_config(cfg.data)
    graphs = dm.split("val")[:4]
    batch = pack_batch(graphs, PadBudget.for_dataset(graphs, 4),
                       with_spmm_plan=True)
    model = build_mpnn(cfg.mpnn, dm.num_features, dm.num_classes,
                       readout="none",
                       generator=torch.Generator().manual_seed(1))
    model.eval()
    outs = {}
    prev = spmm.get_backend()
    spmm.set_backend("pallas")    # the kernel path, plain versions on CPU
    try:
        for dev, m in (("cpu", model), ("cuda", copy.deepcopy(model))):
            m = m.to(dev)
            b = batch.to(dev)
            logits = m(b)
            loss, _ = criterion("softmax_cross_entropy", logits, b.node_y,
                                b.node_mask)
            grads = torch.autograd.grad(loss, list(m.parameters()))
            outs[dev] = [logits.detach()] + list(grads)
    finally:
        spmm.set_backend(prev)
    worst = 0.0
    for ref, got in zip(outs["cpu"], outs["cuda"]):
        err = float((got.cpu() - ref).abs().max())
        tol = 1e-4 * max(float(ref.abs().max()), 1e-3)
        if not got.isfinite().all() or err > tol:
            fail(f"card vs CPU: max |err| {err:.3e} > {tol:.3e}")
        worst = max(worst, err / max(float(ref.abs().max()), 1e-3))
    print(f"[reference] 4-graph batch (N={batch.num_nodes_padded}): logits "
          f"and {len(outs['cpu']) - 1} gradients agree with the CPU, worst "
          f"relative error {worst:.2e}", flush=True)


def main() -> int:
    if not (REPO / "graph_hscn_tpu_torch" / "csrc").is_dir():
        fail(f"{REPO} holds no graph_hscn_tpu_torch package: run the script "
             "from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    try:
        import torch  # noqa: F401
    except ImportError:
        fail("PyTorch is not installed")
    name, count, smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    launches = phase_train()
    phase_profile()
    phase_reference()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
