
#!/usr/bin/env python3
"""Time the port's hand CUDA kernels (graph_hscn_tpu_torch/csrc/) on one
NVIDIA card, at the shapes of PERF.md's table of kernels.

    python3 chip_smoke.py

Each kernel is compared once with its plain PyTorch version (a time of a
wrong kernel misleads: a kernel outside its tolerance exits non-zero), then
timed with CUDA events: the kernel cold (each call on the next of copies of
its inputs that span 4x the L2, ``rotating``) and warm (the same inputs
call after call), its plain version, a library call or yardstick, and the
bound of its bytes and operations at the card's peak rates.  Phases:
  [device]     the card's name, count, and nvidia-smi's name and power
               limit; without a CUDA card the script stops here.
  [build]      nvcc builds every kernel, one process per source; seconds
               and ptxas -v.
  [kernels]    csr_spmm (B1) and edge_sddmm (B3) at a VOC-superpixels
               sparse GCN batch (F = 64 and 21, float32 and bfloat16), the
               floor of a launch; csr_spmm at the VOC sparse HSCN batch
               (F = 32) and the peptides GIN sparse batch (F = 9 and 16).
  [fused]      fused_gcn_fwd / fused_gcn_bwd (B2f, B2b) at the peptides
               batch (G = 32, slot 392, 9 -> 16 -> 16 -> 10; no dropout,
               given bits, seeded Philox), beside the unfused dense stack;
               then at S = 512, hidden 128, 5 layers and at S = 1024 with
               input width 64 (A_hat streamed).
  [gat]        spmm_mh (B6) and sddmm_mh (B7) at the VOC GAT batch, every
               width and role of a train step, and gat_edge_logits; the
               library call on the block-diagonal [H*N, H*N] CSR.
  [gatedgcn]   segment_reduce (B5) at the VOC GatedGCN batch (F = 64):
               receiver and sender side, and a batch with empty rows.
  [graph_attn] GraphMHA's attention (graph_attn, graph_attn_bwd) at the
               peptides_func_gps cell's shape (128 graphs, slot 448, 4
               heads of 24, dropout 0.5), against the plain version in
               float64, beside the draw and scaled_dot_product_attention.
  [hbm]        csr_spmm and edge_sddmm at F = 128 on the 142 x 142 and
               226 x 226 lattices (B4a-c's sizes).
  [edge_partition] the train block of the edge-partition GCN, GatedGCN
               and HSCN configs packed as one rank packs it: csr_spmm,
               spmm_mh / sddmm_mh and segment_reduce at their widths.
  [dp]         csr_spmm at configs/GCN/peptides_func_GCN_dp8.yaml's sparse
               batch (F = 128 and 10), the fused kernels at G = 128,
               S = 392, hidden 128.
  [hybrid]     csr_spmm and the one-head spmm_mh / sddmm_mh at the hybrid
               config's train block on a (1, 1) mesh.
Correctness on the card belongs to ``pytest -m gpu tests/test_torch_cuda.py``;
where a fit's time goes, to ``runtime.profile_dir`` and benchmarks/.  The
last three lines are the {"kernels": [...]} record (each kernel's error,
time, plain, library and bound at its table shape), nvidia-smi's line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CONFIGS = REPO / "configs"
CONFIG = CONFIGS / "GCN" / "voc_superpixels_GCN_sparse.yaml"
PEPTIDES_FUSED = CONFIGS / "GCN" / "peptides_func_GCN_fused.yaml"
VOC_GAT = CONFIGS / "GAT" / "voc_superpixels_GAT_sparse.yaml"
VOC_GATED = CONFIGS / "GatedGCN" / "voc_superpixels_GatedGCN_sparse.yaml"
VOC_HSCN = CONFIGS / "HSCN" / "voc_superpixels_HSCN_sparse.yaml"
GIN = CONFIGS / "GIN" / "peptides_func_GIN.yaml"
# The GIN config on sparse batches: the host loop with the CSR plan, each
# GINConv's aggregation through csr_spmm.
GIN_SPARSE = {"runtime.dense_path": "sparse", "runtime.device_dataset": "off"}
# The edge-partition configs ask for an 8-device mesh; their blocks here
# are a 1-rank mesh's, every other key as shipped.
GCN_EP = CONFIGS / "GCN" / "voc_superpixels_GCN_edge_partition.yaml"
GATED_EP = (CONFIGS / "GatedGCN"
            / "voc_superpixels_GatedGCN_edge_partition.yaml")
HSCN_EP = CONFIGS / "HSCN" / "voc_superpixels_HSCN_edge_partition.yaml"
DP8 = CONFIGS / "GCN" / "peptides_func_GCN_dp8.yaml"
HYBRID = CONFIGS / "GCN" / "voc_superpixels_GCN_hybrid.yaml"
HBM_SIDES = (142, 226)   # lattices of N = 20164 and 51076 (B4a, B4b sizes)
FUSED_SEED = 20261016   # the seeded-dropout case's Philox key
# Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, and float32
# operations/s outside the tensor cores (the kernels' FMAs run there).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
L2_BYTES = 50 * 2**20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ops(fn, calls: int) -> list:
    """The device operations (kernels, copies and fills) of ``calls``
    calls of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


# Launches queued behind the device sleep stay well inside the card's launch
# queue (~1k entries): once it is full the host waits on the device, and the
# events would time the host's launch rate instead.
MAX_QUEUED = 256


def time_ms(fn, iters: int = 100, warmup: int = 20) -> tuple[float, float]:
    """(device ms, host ms) of one call.  Host: wall time of ``iters``
    calls ending in a sync.  Device: CUDA events around n calls queued
    behind a device sleep longer than the host needs to enqueue them, so
    the events time back-to-back execution on the card; n = iters, cut so
    that n times the call's device operations (counted by the profiler)
    stays within MAX_QUEUED.  A call of more operations than that is timed
    by the profiler instead: its device operations' summed durations."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    calls = 3
    dev = device_ops(fn, calls)
    ops = len(dev) / calls
    if ops > MAX_QUEUED:
        return sum(e.time_range.elapsed_us() for e in dev) / calls / 1e3, \
            host_ms
    # (No device operations seen: the profiler is blind here; few calls.)
    n = (max(1, min(iters, int(MAX_QUEUED // ops))) if ops
         else min(iters, 10))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~2e6 clock cycles a millisecond at the card's ~2 GHz.
    torch.cuda._sleep(int(1.5 * host_ms * n * 2e6) + 2_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, host_ms


def nbytes_of(t) -> int:
    """Bytes of a dense or CSR tensor."""
    import torch
    if t.layout == torch.sparse_csr:
        return sum(nbytes_of(u) for u in (t.crow_indices(), t.col_indices(),
                                          t.values()))
    return t.numel() * t.element_size()


def rotating(fn, *args):
    """A call of ``fn`` on the next of k copies of ``args``, k such that the
    copies span at least 4x the L2: ``time_ms`` of it times calls whose
    inputs come from HBM, as ``bound_ms`` assumes, and not from an L2 that
    the previous call filled.  Arguments that are not tensors are shared."""
    import torch
    size = sum(nbytes_of(a) for a in args if isinstance(a, torch.Tensor))
    k = max(2, math.ceil(4 * L2_BYTES / size))
    copies = [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                             for a in args) for _ in range(k - 1)]
    turn = itertools.cycle(copies)
    return lambda: fn(*next(turn))


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


def csr_tensor(row_ptr, col, vals):
    """A plan's matrix (its real edges) as a torch CSR tensor for a library
    yardstick, columns sorted within each row (what cuSPARSE expects; the
    product is unchanged)."""
    import torch
    n, nnz = row_ptr.numel() - 1, int(row_ptr[-1])
    rows = torch.repeat_interleave(torch.arange(n, device=row_ptr.device),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    srt = torch.argsort(rows * n + col[:nnz].long())
    return torch.sparse_csr_tensor(row_ptr.long(), col[:nnz].long()[srt],
                                   vals[:nnz][srt], (n, n),
                                   check_invariants=True)


def block_diag_csr(row_ptr, col, vals):
    """A plan's matrix with per-head weights ``vals`` [E, H] as one
    block-diagonal [H*N, H*N] torch CSR tensor (block h weighted by
    vals[:, h]), for a library call that does all heads at once against a
    head-major [H*N, C] operand.  Also returns the order of its values:
    block h's values are the real edges ``order`` with head h."""
    import torch
    n, nnz = row_ptr.numel() - 1, int(row_ptr[-1])
    heads = vals.shape[1]
    rows = torch.repeat_interleave(torch.arange(n, device=row_ptr.device),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    order = torch.argsort(rows * n + col[:nnz].long())
    blocks = torch.arange(heads, device=row_ptr.device)[:, None]
    crow = torch.cat([(row_ptr[:-1].long() + blocks * nnz).reshape(-1),
                      row_ptr.new_full((1,), heads * nnz).long()])
    cols = (col[:nnz].long()[order] + blocks * n).reshape(-1)
    values = vals[:nnz][order].t().reshape(-1)
    return (torch.sparse_csr_tensor(crow, cols, values,
                                    (heads * n, heads * n),
                                    check_invariants=True), order)


def head_major(x, heads: int):
    """[N, H*C] -> [H*N, C], head h's rows in block h."""
    n = x.shape[0]
    return x.reshape(n, heads, -1).transpose(0, 1).reshape(heads * n, -1)


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


def phase_build() -> dict:
    """Build every kernel; returns {kernel: nvcc's output (ptxas -v)}."""
    from graph_hscn_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    results = build.build_all()
    print(f"[build] {len(results)} kernels in "
          f"{time.perf_counter() - t0:.2f} s (sm_90a)", flush=True)
    for r in results:
        print(f"[build] {r.name}: {r.seconds:.2f} s -> {r.path.name}")
        for line in r.log.strip().splitlines():
            print(f"[build]   {line}")
    return {r.name: r.log for r in results}


def warm_up_card(seconds: float = 1.0) -> None:
    """Keep the card busy for a while before the first timing, so that the
    first timed case does not read its clocks ramping up."""
    import torch
    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = torch.tanh(a @ a * 1e-3)
        torch.cuda.synchronize()


def phase_kernels():
    """Hold csr_spmm (B1) and edge_sddmm (B3) against their plain versions
    at the VOC GCN path's shapes (F = 64 and 21, float32 and bfloat16; the
    transpose with the weights read in t_order by the kernel), each with
    its launch plan, timed cold (``rotating``: inputs from HBM, as the
    bound assumes) with the warm time beside; then the floor of a launch
    under the same timer.  Returns the kernels' records: F=64 float32,
    forward and dw, cold."""
    import torch

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.ops.cuda.sddmm_kernel import (
        edge_sddmm, edge_sddmm_plain, edge_sddmm_plan)
    from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import (csr_spmm,
                                                           csr_spmm_plain,
                                                           csr_spmm_plan)
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
    warm_up_card()

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
            # (name, role, kernel, plain version, arguments, bytes, plan,
            # library call, its arguments)
            runs = [
                ("csr_spmm", "forward", csr_spmm, csr_spmm_plain,
                 (x, p.row_ptr, p.col, w),
                 n * f * sz + (n + 1) * 4 + nnz * 8 + n * f * 4,
                 csr_spmm_plan(f, dtype), torch.sparse.mm, (a_csr, x)),
                ("edge_sddmm", "dw", edge_sddmm, edge_sddmm_plain,
                 (x, g, p.row, p.col, nnz),
                 n * f * sz + n * f * 4 + nnz * 8 + e * 4,
                 edge_sddmm_plan(f, dtype),
                 lambda a, g, xt: torch.sparse.sampled_addmm(a, g, xt,
                                                             beta=0.0),
                 (a_pat, g, xt)),
            ]
            if dtype == torch.float32:   # the backward's g is float32
                runs.append(
                    ("csr_spmm", "transpose", csr_spmm, csr_spmm_plain,
                     (g, p.t_row_ptr, p.t_col, w, p.t_order),
                     n * f * 4 + (n + 1) * 4 + nnz * 16 + n * f * 4,
                     csr_spmm_plan(f, dtype), torch.sparse.mm,
                     (at_csr, g)))
            for name, role, kern, plain, args, nbytes, plan, lib, lib_args \
                    in runs:
                out, ref = kern(*args), plain(*args)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                tol = 1e-5 * max(float(ref.abs().max()), 1.0)
                if not out.isfinite().all() or err > tol:
                    fail(f"{name} {role} F={f} {dtype}: max |err| {err:.3e} "
                         f"> tolerance {tol:.3e}")
                worst[name] = max(worst[name], err)
                lib_ms, why = None, "float32 only"
                if dtype == torch.float32:
                    lib_ms, why = library_ms(rotating(lib, *lib_args))
                b_ms, b_by = bound_ms(nbytes, 2.0 * nnz * f)
                # Cold: inputs from HBM (the bound's premise); warm: the
                # same inputs call after call, left in the L2.
                k_ms, k_host = time_ms(rotating(kern, *args))
                warm_ms, _ = time_ms(lambda k=kern, a=args: k(*a))
                p_ms, p_host = time_ms(rotating(plain, *args))
                case = dict(name=name, role=role, f=f,
                            dtype=str(dtype).replace("torch.", ""),
                            max_abs_err=err, tol=tol, ms=k_ms,
                            plain_ms=p_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=b_by)
                cases.append(case)
                print(f"[kernels] {name:10s} {role:9s} F={f:2d} "
                      f"{case['dtype']:8s} err {err:.2e} (tol {tol:.1e}) "
                      f"device, cold L2: kernel {k_ms * 1e3:7.2f} us "
                      f"({b_ms / k_ms:.2f} of bound)  plain "
                      f"{p_ms * 1e3:7.2f} us  bound {b_ms * 1e3:5.2f} us "
                      f"({b_by})  library "
                      + (f"{lib_ms * 1e3:7.2f} us" if lib_ms is not None
                         else f"n/a ({why})")
                      + f"; kernel warm L2 {warm_ms * 1e3:7.2f} us; host a "
                      f"call: kernel {k_host * 1e3:6.2f} us  plain "
                      f"{p_host * 1e3:6.2f} us; plan {plan.label()}",
                      flush=True)
                if (f, case["dtype"], role) in ((64, "float32", "forward"),
                                                (64, "float32", "dw")):
                    print(f"[kernels] {name} F=64 float32: cold "
                          f"{k_ms * 1e3:.2f} us against half its bound's "
                          f"target {2 * b_ms * 1e3:.2f} us: "
                          + ("met" if k_ms <= 2 * b_ms else "NOT met"),
                          flush=True)
    kernel_floors(p)
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


def kernel_floors(p) -> None:
    """What a csr_spmm or edge_sddmm launch costs before its feature bytes,
    under the timer of the kernels' rows: the launch alone (a 1-row plan
    with no edge; one edge of one 64-value row, warm), and the index chain
    with almost no feature bytes (F = 1 on the VOC plan ``p``, cold).
    These launches are held against their plain versions too."""
    import torch

    from graph_hscn_tpu_torch.ops.cuda.sddmm_kernel import (
        edge_sddmm, edge_sddmm_plain)
    from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import (csr_spmm,
                                                           csr_spmm_plain)

    n, nnz = p.num_nodes, p.num_edges
    zero = torch.zeros(2, dtype=torch.int32, device="cuda")
    one = zero[:1]
    x1 = torch.randn(1, 64, device="cuda")
    x = torch.randn(n, 1, device="cuda")
    w = torch.rand(p.col.numel(), device="cuda")
    floors = [
        ("csr_spmm", "launch alone (1 row, no edge, F=64)", False, csr_spmm,
         csr_spmm_plain, (x1, zero, one[:0], w[:0])),
        ("edge_sddmm", "launch alone (1 edge, F=64)", False, edge_sddmm,
         edge_sddmm_plain, (x1, x1, one, one, 1)),
        ("csr_spmm", "index chain (VOC plan, F=1)", True, csr_spmm,
         csr_spmm_plain, (x, p.row_ptr, p.col, w)),
        ("edge_sddmm", "index chain (VOC plan, F=1)", True, edge_sddmm,
         edge_sddmm_plain, (x, x, p.row, p.col, nnz)),
    ]
    for name, label, cold, kern, plain, args in floors:
        out, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max()) if ref.numel() else 0.0
        tol = 1e-5 * max(float(ref.abs().max()) if ref.numel() else 0.0, 1.0)
        if not out.isfinite().all() or err > tol:
            fail(f"{name} floor {label}: max |err| {err:.3e} > tolerance "
                 f"{tol:.3e}")
        k_ms, host_ms = time_ms(rotating(kern, *args) if cold
                                else lambda k=kern, a=args: k(*a))
        print(f"[kernels] floor {name:10s} {label:36s} device "
              f"{'cold' if cold else 'warm'}: {k_ms * 1e3:6.2f} us; host a "
              f"call {host_ms * 1e3:6.2f} us", flush=True)


def _timing(case: dict, worst_err: float) -> dict:
    return {"max_abs_err": worst_err, "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"]}


def gat_batch_plan():
    """The CSR plan of the VOC GAT config's first train batch, on the card."""
    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.data.pipeline import DataModule

    cfg = load_config(VOC_GAT)
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    dm.with_spmm_plan = True
    return next(iter(dm.train_batches(epoch_seed=dm.seed))).to("cuda").spmm


GAT_SPMM_SHAPES = ((4, 16), (4, 21), (4, 2))


def gat_cases(p, spmm_shapes=GAT_SPMM_SHAPES, sddmm_shapes=None) -> list:
    """Every width and role at which a VOC GAT train step launches spmm_mh
    (B6) and sddmm_mh (B7), on plan ``p``, float32 and bfloat16:
    - spmm_mh forward (row_ptr, col) and transpose (t_row_ptr, t_col, alpha
      read in t_order by the kernel) at H*C = 64 and 84 (the layers'
      aggregation and its dx) and 8 (the logits' d a_dst and d a_src);
    - sddmm_mh at C = 16 (float32, bfloat16, bfloat16 with float32: spmm_mh's
      d alpha), 21 and 2 (the logits and the max shift).
    Each case: its kernel call and plain version (function, arguments), the
    bytes and operations of its bound (each input read once: t_order's
    int64 entries on the transpose), its inputs, and a library call (one
    torch.sparse.mm / sampled_addmm on the block-diagonal [H*N, H*N] CSR,
    against head-major float32 operands laid out beforehand; float32 only)
    with the map of its result to the kernel's layout.  ``spmm_shapes``
    ((H, C), ...) and ``sddmm_shapes`` ((H, C, source dtype, destination
    dtype), ...): another path's widths."""
    import torch

    from graph_hscn_tpu_torch.ops.cuda.multihead_kernel import (
        sddmm_mh, sddmm_mh_plain, spmm_mh, spmm_mh_plain)

    n, e, nnz = p.num_nodes, p.col.numel(), p.num_edges
    gen = torch.Generator(device="cuda").manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for heads, c in spmm_shapes:
        f = heads * c
        alpha = torch.rand(e, heads, device="cuda", generator=gen)
        a_t = alpha.index_select(0, p.t_order).contiguous()
        for role, rp, col, order, a_ref in (
                ("forward", p.row_ptr, p.col, None, alpha),
                ("transpose", p.t_row_ptr, p.t_col, p.t_order, a_t)):
            a_bd, _ = block_diag_csr(rp, col, a_ref)
            for dtype in (f32, bf16):
                x = torch.randn(n, f, device="cuda", generator=gen).to(dtype)
                lib = None
                if dtype == f32:
                    lib = (torch.sparse.mm,
                           (a_bd, head_major(x, heads).contiguous()),
                           lambda y, h=heads: y.reshape(h, n, -1).transpose(
                               0, 1).reshape(n, -1))
                cases.append(dict(
                    name="spmm_mh", role=role, heads=heads, c=c,
                    dtype=str(dtype).replace("torch.", ""),
                    kern=spmm_mh, args=(x, alpha, rp, col, order),
                    plain=spmm_mh_plain, plain_args=(x, a_ref, rp, col),
                    nbytes=(n * f * x.element_size() + nnz * heads * 4
                            + (n + 1) * 4 + nnz * 4 + n * f * 4
                            + (nnz * 8 if order is not None else 0)),
                    ops=2.0 * nnz * f, lib=lib))
    if sddmm_shapes is None:
        sddmm_shapes = ((4, 16, f32, f32), (4, 16, bf16, bf16),
                        (4, 16, bf16, f32), (4, 21, f32, f32),
                        (4, 21, bf16, bf16), (4, 2, f32, f32),
                        (4, 2, bf16, bf16))
    for heads, c, ds, dd in sddmm_shapes:
        pattern, order = block_diag_csr(p.row_ptr, p.col,
                                        torch.zeros(e, heads, device="cuda"))
        f = heads * c
        hs = torch.randn(n, f, device="cuda", generator=gen).to(ds)
        hd = torch.randn(n, f, device="cuda", generator=gen).to(dd)
        lib = None
        if (ds, dd) == (f32, f32):
            def as_ref(y, h=heads):
                """Block-diagonal CSR values -> [E, H] in edge order."""
                dots = torch.zeros(e, h, device="cuda")
                dots[order] = y.values().reshape(h, nnz).t()
                return dots

            # Rows of the pattern are receivers: dst @ src^T, sampled.
            lib = (lambda pat, a, b: torch.sparse.sampled_addmm(
                pat, a, b, beta=0.0),
                   (pattern, head_major(hd, heads).contiguous(),
                    head_major(hs, heads).t().contiguous()), as_ref)
        cases.append(dict(
            name="sddmm_mh", role="dots", heads=heads, c=c,
            dtype="/".join(str(t).replace("torch.", "") for t in (ds, dd))
            if ds != dd else str(ds).replace("torch.", ""),
            kern=sddmm_mh, args=(hs, hd, p.row, p.col, nnz, heads),
            plain=sddmm_mh_plain, plain_args=(hs, hd, p.row, p.col, nnz,
                                              heads),
            nbytes=(n * f * (hs.element_size() + hd.element_size())
                    + nnz * 8 + e * heads * 4),
            ops=2.0 * nnz * f, lib=lib))
    return cases


def plan_label(plan) -> str:
    """A launch plan of the multi-head kernels in a few words."""
    return (("row" if plan.row_layout else "head") + f" layout V={plan.vec} "
            f"VP={plan.passes} S={plan.lanes_per_head} L={plan.lanes} "
            f"B={plan.batch}")


def check_case(case: dict) -> tuple[float, float]:
    """Hold a case's kernel against its plain version (1e-5*max|ref| when
    every operand is float32, 1e-4*max|ref| with a bfloat16 one) and its
    library call to the same tolerance; fails the run otherwise.  Returns
    (max |err|, tol)."""
    import torch
    out = case["kern"](*case["args"])
    ref = case["plain"](*case["plain_args"])
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol_rel = 1e-5 if case["dtype"] == "float32" else 1e-4
    tol = tol_rel * max(float(ref.abs().max()), 1e-6)
    label = (f"{case['name']} {case['role']} H={case['heads']} "
             f"C={case['c']} {case['dtype']}")
    if not out.isfinite().all() or err > tol:
        fail(f"{label}: max |err| {err:.3e} > tolerance {tol:.3e}")
    if case["lib"] is not None:
        fn, args, as_ref = case["lib"]
        lib_err = float((as_ref(fn(*args)) - ref).abs().max())
        if lib_err > tol:
            fail(f"{label} library call: max |err| {lib_err:.3e} > "
                 f"tolerance {tol:.3e}")
    return err, tol


def time_case(tag: str, case: dict) -> tuple[float, dict]:
    """A multi-head case (``gat_cases``) held against its plain version
    (``check_case``), then timed cold (``rotating``, inputs from HBM as the
    bound assumes) with the warm time beside: kernel, plain version and
    library call; prints one ``tag`` line.  Returns (max |err|, {ms,
    plain_ms, library_ms, bound_ms, bound_by})."""
    import torch

    from graph_hscn_tpu_torch.ops.cuda.multihead_kernel import multihead_plan

    err, tol = check_case(case)
    name = case["name"]
    lib_ms, why = None, "float32 only"
    if case["lib"] is not None:
        fn, args, _ = case["lib"]
        lib_ms, why = library_ms(rotating(fn, *args))
    b_ms, b_by = bound_ms(case["nbytes"], case["ops"])
    k_ms, k_host = time_ms(rotating(case["kern"], *case["args"]))
    warm_ms, _ = time_ms(lambda c=case: c["kern"](*c["args"]))
    p_ms, _ = time_ms(rotating(case["plain"], *case["plain_args"]))
    ds = case["args"][0].dtype
    if name == "sddmm_mh" and torch.bfloat16 in (ds, case["args"][1].dtype):
        ds = torch.bfloat16
    plan = multihead_plan(name, case["heads"], case["c"], ds)
    label = f"H={case['heads']} C={case['c']}"
    print(f"{tag} {name:8s} {case['role']:9s} {label:8s} "
          f"{case['dtype']:15s} err {err:.2e} (tol {tol:.1e}) device, "
          f"cold L2: kernel {k_ms * 1e3:7.2f} us ({b_ms / k_ms:.2f} of "
          f"bound)  plain {p_ms * 1e3:8.2f} us  bound "
          f"{b_ms * 1e3:5.2f} us ({b_by})  library "
          + (f"{lib_ms * 1e3:7.2f} us" if lib_ms is not None
             else f"n/a ({why})")
          + f"; kernel warm L2 {warm_ms * 1e3:7.2f} us; host a call "
          f"{k_host * 1e3:6.2f} us; plan {plan_label(plan)}", flush=True)
    return err, dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                     bound_ms=b_ms, bound_by=b_by)


def phase_gat_kernels():
    """spmm_mh (B6) and sddmm_mh (B7) at the VOC GAT batch shape (N=19048,
    72832 edge slots), every width and role of the step (gat_cases) and
    gat_edge_logits, against their plain versions.  Kernel, plain version
    and library call timed cold (``rotating``, inputs from HBM as the bound
    assumes), the kernel warm beside it.  Returns the two kernels' records:
    H=4 C=16 float32, forward and dots, cold."""
    import torch

    from graph_hscn_tpu_torch.ops.cuda.multihead_kernel import (
        gat_edge_logits, sddmm_mh_plain)

    p = gat_batch_plan()
    n, e, nnz = p.num_nodes, p.col.numel(), p.num_edges
    print(f"[gat] VOC GAT batch: N={n} E={e} real edges={nnz}", flush=True)
    worst = {"spmm_mh": 0.0, "sddmm_mh": 0.0}
    records = {}
    for case in gat_cases(p):
        err, rec = time_case("[gat]", case)
        name = case["name"]
        worst[name] = max(worst[name], err)
        if (case["role"], case["c"], case["dtype"]) in (
                ("forward", 16, "float32"), ("dots", 16, "float32")):
            records[name] = rec
            k_ms, b_ms = rec["ms"], rec["bound_ms"]
            print(f"[gat] {name} H=4 C=16 float32: cold {k_ms * 1e3:.2f} us "
                  f"against half its bound's target {2 * b_ms * 1e3:.2f} us: "
                  + ("met" if k_ms <= 2 * b_ms else "NOT met"), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    a_src = torch.randn(n, 4, device="cuda", generator=gen)
    a_dst = torch.randn(n, 4, device="cuda", generator=gen)

    def logits_plain():
        ones = torch.ones_like(a_src)
        hs = torch.stack([a_src, ones], -1).reshape(n, 8)
        hd = torch.stack([ones, a_dst], -1).reshape(n, 8)
        return sddmm_mh_plain(hs, hd, p.row, p.col, nnz, 4)

    out, ref = gat_edge_logits(a_src, a_dst, p), logits_plain()
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = 1e-5 * max(float(ref.abs().max()), 1e-6)
    if not out.isfinite().all() or err > tol:
        fail(f"gat_edge_logits: max |err| {err:.3e} > tolerance {tol:.3e}")
    k_ms, _ = time_ms(lambda: gat_edge_logits(a_src, a_dst, p))
    p_ms, _ = time_ms(logits_plain)
    print(f"[gat] gat_edge_logits H=4 C=2 float32 err {err:.2e} (tol "
          f"{tol:.1e}) device, warm: {k_ms * 1e3:.2f} us (stack + sddmm_mh), "
          f"plain {p_ms * 1e3:.2f} us", flush=True)
    src = "graph_hscn_tpu_torch/csrc/{}.cu"
    pallas = "graph_hscn_tpu/ops/pallas/multihead_kernel.py:{}"
    return [
        {"name": "spmm_mh", "route": "cuda", "source": src.format("spmm_mh"),
         "replaces": pallas.format(53),
         **_timing(records["spmm_mh"], worst["spmm_mh"])},
        {"name": "sddmm_mh", "route": "cuda",
         "source": src.format("sddmm_mh"), "replaces": pallas.format(133),
         **_timing(records["sddmm_mh"], worst["sddmm_mh"])},
    ]


def segment_reduce_case(tag: str, label: str, msgs, rp, order,
                        rows: int) -> dict:
    """segment_reduce (B5) of ``msgs`` [E, F] by the row pointers ``rp``
    (``order``: the rows taken in it, the sender side) against its plain
    version (1e-5 * max|ref| in float32, 1e-4 in bfloat16); kernel, plain
    version and library call (torch.segment_reduce on the rows laid out
    beforehand, float32) timed cold (``rotating``), the kernel warm too,
    beside the bound of ``rows`` real rows.  Prints one line; returns the
    case's record with its output (``out``)."""
    import torch

    from graph_hscn_tpu_torch.ops.cuda.segment_reduce_kernel import (
        segment_reduce, segment_reduce_plain)

    n, f = rp.numel() - 1, msgs.shape[1]
    esize = msgs.element_size()
    f32 = msgs.dtype == torch.float32
    out = segment_reduce(msgs, rp, order)
    ref = segment_reduce_plain(msgs, rp, order)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = (1e-5 if f32 else 1e-4) * max(float(ref.abs().max()), 1e-6)
    if not out.isfinite().all() or err > tol:
        fail(f"segment_reduce {tag} {label} {msgs.dtype}: max |err| "
             f"{err:.3e} > tolerance {tol:.3e}")
    lib_ms, why = None, "float32 only"
    if f32:
        laid = (msgs[:rows] if order is None
                else msgs.index_select(0, order[:rows]))

        def lib(laid, offsets):
            return torch.segment_reduce(laid, "sum", offsets=offsets)

        try:
            lib_err = float((lib(laid, rp.long()) - ref).abs().max())
        except (RuntimeError, NotImplementedError) as exc:
            why = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
        else:
            if lib_err > tol:
                fail(f"segment_reduce {tag} {label} library call: max |err| "
                     f"{lib_err:.3e} > tolerance {tol:.3e}")
            lib_ms, why = library_ms(rotating(lib, laid, rp.long()))
    nbytes = (rows * f * esize + (n + 1) * 4 + n * f * 4
              + (rows * 8 if order is not None else 0))
    b_ms, b_by = bound_ms(nbytes, 1.0 * rows * f)
    # Cold: inputs from HBM (the bound's premise); warm: the same inputs
    # call after call, left in the L2 by the previous one.
    k_ms, k_host = time_ms(rotating(segment_reduce, msgs, rp, order))
    warm_ms, _ = time_ms(lambda: segment_reduce(msgs, rp, order))
    p_ms, _ = time_ms(rotating(segment_reduce_plain, msgs, rp, order))
    dtype = str(msgs.dtype).replace("torch.", "")
    print(f"{tag} segment_reduce {label:10s} F={f} {dtype:8s} err "
          f"{err:.2e} (tol {tol:.1e}) device, cold L2: kernel "
          f"{k_ms * 1e3:7.2f} us  plain {p_ms * 1e3:7.2f} us  bound "
          f"{b_ms * 1e3:5.2f} us ({b_by})  library "
          + (f"{lib_ms * 1e3:7.2f} us" if lib_ms is not None
             else f"n/a ({why})")
          + f"; kernel warm L2 {warm_ms * 1e3:7.2f} us; host a call "
          f"{k_host * 1e3:6.2f} us", flush=True)
    return dict(label=label, dtype=dtype, max_abs_err=err, ms=k_ms,
                plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, out=out)


def phase_gatedgcn_kernels():
    """segment_reduce (B5) at the VOC GatedGCN batch shape (F = 64, the
    layers' width), against its plain version: float32 and bfloat16 rows,
    the receiver side (rows in edge order, segment_sum_planned and the
    receiver gather's backward) and the sender side (rows taken in t_order,
    the sender gathers' backward), and the same batch with every other
    row's edges taken out (empty rows).  Kernel, plain version and library
    call are timed cold (``rotating``).  Returns the kernel's record."""
    import torch

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.data.pipeline import DataModule

    cfg = load_config(VOC_GATED)
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    dm.with_spmm_plan = True
    p = next(iter(dm.train_batches(epoch_seed=dm.seed))).to("cuda").spmm
    n, e, nnz = p.num_nodes, p.col.numel(), p.num_edges
    f = cfg.mpnn.hidden_channels
    # Empty rows: every other row keeps no edge (its edges leave the CSR).
    counts = (p.row_ptr[1:] - p.row_ptr[:-1]).clone()
    counts[::2] = 0
    sparse_ptr = torch.zeros_like(p.row_ptr)
    sparse_ptr[1:] = counts.cumsum(0)
    nnz_sparse = int(sparse_ptr[-1])
    print(f"[gatedgcn] VOC GatedGCN batch: N={n} E={e} real edges={nnz}, "
          f"F={f}; empty-rows case: {int((counts == 0).sum())} empty rows, "
          f"{nnz_sparse} edges", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases, worst = [], 0.0
    for dtype in (torch.float32, torch.bfloat16):
        msgs = torch.randn(e, f, device="cuda", generator=gen).to(dtype)
        for label, rp, order, rows in (
                ("receiver", p.row_ptr, None, nnz),
                ("sender", p.t_row_ptr, p.t_order, nnz),
                ("empty rows", sparse_ptr, None, nnz_sparse)):
            case = segment_reduce_case("[gatedgcn]", label, msgs, rp, order,
                                       rows)
            if label == "empty rows" and case["out"][counts == 0].any():
                fail("segment_reduce: an empty row is not 0")
            del case["out"]
            worst = max(worst, case["max_abs_err"])
            cases.append(case)
    (record,) = [c for c in cases
                 if (c["label"], c["dtype"]) == ("receiver", "float32")]
    return [{"name": "segment_reduce", "route": "cuda",
             "source": "graph_hscn_tpu_torch/csrc/segment_reduce.cu",
             "replaces": "graph_hscn_tpu/ops/pallas/sddmm_kernel.py:187",
             **_timing(record, worst)}]


def graph_attn_bound(n_nodes, nh: int, hd: int, backward: bool) -> tuple:
    """The work of graph_attn (or its backward) at the real pairs of graphs
    of ``n_nodes`` nodes, float32: (bytes, flops).  Flops: 4 * hd a real
    pair and head forward (the score, its share of P V), 10 * hd backward
    (the score again, dA, dV, dQ, dK).  Bytes: the real rows of q, k, v
    read and out written, the draw read and the keep bits written at the
    real pairs, lse written (forward); q, k, v, out, dO read and dq, dk, dv
    written, the keep bits and lse read, D written and read (backward)."""
    n = np.asarray(n_nodes, np.int64)
    pairs = float((n ** 2).sum()) * nh
    rows = float(n.sum()) * nh
    if backward:
        return 8 * rows * hd * 4 + pairs / 8 + 3 * rows * 4, 10 * hd * pairs
    return 4 * rows * hd * 4 + pairs * 4 + pairs / 8 + rows * 4, \
        4 * hd * pairs


def phase_graph_attn_kernels():
    """[graph_attn] GraphMHA's attention (graph_attn, graph_attn_bwd) at the
    peptides_func_gps cell's shape: 128 graphs of the cell's node counts
    (the generator's), slot 448, 4 heads of 24, dropout 0.5 from a
    [128, 4, 448, 448] draw.  Kernels against the plain version in float64
    with the same bits (1e-5 * max|ref|, the output at real query rows,
    every gradient); timed warm, each kernel cold beside it: each kernel,
    the draw, the plain version's forward (its draw in it) and forward plus
    backward in float32, and scaled_dot_product_attention with the same
    key mask and rate (its own bits) as the library yardstick, forward and
    forward plus backward.  Returns the kernels' records."""
    import torch
    import torch.nn.functional as F

    from graph_hscn_tpu_torch.data.synthetic import make_peptides_func
    from graph_hscn_tpu_torch.ops.cuda.graph_attn_kernel import (
        extent, graph_attention_plain, graph_attn, graph_attn_bwd)

    G, S, nh, hd, rate = 128, 448, 4, 24, 0.5
    scale = 1.0 / (1.0 - rate)
    n_nodes = [g.num_nodes for g in make_peptides_func(num_graphs=G, seed=0)]
    mask = (torch.arange(S)[None, :]
            < torch.tensor(n_nodes)[:, None]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, grad = (torch.randn(G, S, nh, hd, device="cuda", generator=gen)
                     for _ in range(4))
    grad = grad * mask[:, :, None, None]

    def seeded():
        return torch.Generator(device="cuda").manual_seed(7)

    bits = torch.rand((G, nh, S, S), device="cuda", generator=seeded())
    ext = extent(mask)
    out, lse, keep = graph_attn(q, k, v, mask, ext, bits, rate, scale)
    got = (out, *graph_attn_bwd(q, k, v, out, grad, mask, ext, lse, keep,
                                scale))
    ins = [t.double().requires_grad_(True) for t in (q, k, v)]
    ref = graph_attention_plain(*ins, mask, rate, True, seeded())
    ref.backward(grad.double())
    ref = (ref.detach(), *(t.grad for t in ins))
    del ins
    torch.cuda.synchronize()
    errs = []
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        if name == "out":
            a, b = a[mask], b[mask]
        err = float((a.double() - b).abs().max())
        tol = 1e-5 * max(float(b.abs().max()), 1e-6)
        if not a.isfinite().all() or err > tol:
            fail(f"graph_attn {name}: max |err| {err:.3e} > tolerance "
                 f"{tol:.3e}")
        errs.append(err)
    del ref
    fwd_ms, fwd_host = time_ms(lambda: graph_attn(q, k, v, mask, ext, bits,
                                                  rate, scale))
    bwd_ms, bwd_host = time_ms(lambda: graph_attn_bwd(
        q, k, v, out, grad, mask, ext, lse, keep, scale))
    # Cold: each call on the next of copies of its inputs (the draw's
    # copies alone span 8x the L2).
    fwd_cold, _ = time_ms(rotating(
        lambda q, k, v, b: graph_attn(q, k, v, mask, ext, b, rate, scale),
        q, k, v, bits))
    bwd_cold, _ = time_ms(rotating(
        lambda q, k, v, o, g, l, kp: graph_attn_bwd(q, k, v, o, g, mask, ext,
                                                    l, kp, scale),
        q, k, v, out, grad, lse, keep))
    draw_ms, _ = time_ms(lambda: torch.rand((G, nh, S, S), device="cuda",
                                            generator=gen))
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    plain_fwd, _ = time_ms(lambda: graph_attention_plain(
        q, k, v, mask, rate, True, gen), iters=20, warmup=3)
    plain_both, _ = time_ms(lambda: graph_attention_plain(
        qg, kg, vg, mask, rate, True, gen).backward(grad), iters=20,
        warmup=3)
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    heads_g = [t.transpose(1, 2) for t in (qg, kg, vg)]
    key_mask = mask[:, None, None, :]
    lib_fwd, why = library_ms(lambda: F.scaled_dot_product_attention(
        *heads, attn_mask=key_mask, dropout_p=rate))
    lib_both, _ = library_ms(lambda: F.scaled_dot_product_attention(
        *heads_g, attn_mask=key_mask, dropout_p=rate).backward(
            grad.transpose(1, 2)))
    records = []
    for name, src, ms, cold, host, plain, lib, backward, err in (
            ("graph_attn", "graph_attn.cu", fwd_ms, fwd_cold, fwd_host,
             plain_fwd, lib_fwd, False, errs[0]),
            ("graph_attn_bwd", "graph_attn_bwd.cu", bwd_ms, bwd_cold,
             bwd_host, plain_both - plain_fwd,
             None if lib_both is None else lib_both - lib_fwd, True,
             max(errs[1:]))):
        nbytes, ops = graph_attn_bound(n_nodes, nh, hd, backward)
        b_ms, b_by = bound_ms(nbytes, ops)
        print(f"[graph_attn] {name:14s} G={G} S={S} nh={nh} hd={hd} rate "
              f"{rate} float32 err {err:.2e} device, warm L2: kernel "
              f"{ms * 1e3:8.2f} us (cold {cold * 1e3:8.2f})  plain "
              f"{plain * 1e3:9.2f} us  bound "
              f"{b_ms * 1e3:6.2f} us ({b_by}: {nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} GFLOP)  library "
              + (f"{lib * 1e3:9.2f} us" if lib is not None
                 else f"n/a ({why})")
              + f"; host a call {host * 1e3:6.2f} us", flush=True)
        records.append({"name": name, "route": "cuda",
                        "source": f"graph_hscn_tpu_torch/csrc/{src}",
                        "replaces": "none (the JAX package's attention is "
                                    "XLA: graph_hscn_tpu/models/gps.py)",
                        "max_abs_err": err, "ms": ms,
                        "plain_ms": plain, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib})
    print(f"[graph_attn] the draw (torch.rand [{G}, {nh}, {S}, {S}]) "
          f"{draw_ms * 1e3:.2f} us; plain forward (draw in it) "
          f"{plain_fwd * 1e3:.2f} us, forward and backward "
          f"{plain_both * 1e3:.2f} us; library forward "
          + (f"{lib_fwd * 1e3:.2f} us, forward and backward "
             f"{lib_both * 1e3:.2f} us" if lib_fwd is not None
             and lib_both is not None else f"n/a ({why})"), flush=True)
    return records


def phase_hbm():
    """csr_spmm (forward and transpose) and edge_sddmm at F = 128 on the
    square 4-neighbour lattices at which the TPU routes the SpMM to its
    HBM-streamed kernels (B4a at N = 20164, B4b at N = 51076; B4c is their
    dw, edge_sddmm's function), against their plain versions and beside
    torch.sparse.mm / sampled_addmm, all timed cold; the transpose reads
    the weights in t_order in the kernel.  The tolerances of [kernels]."""
    import torch

    from graph_hscn_tpu_torch.data.synthetic import lattice_edges
    from graph_hscn_tpu_torch.ops.cuda.sddmm_kernel import (
        edge_sddmm, edge_sddmm_plain, edge_sddmm_plan)
    from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import (csr_plan,
                                                           csr_spmm,
                                                           csr_spmm_plain,
                                                           csr_spmm_plan)

    f = 128
    gen = torch.Generator(device="cuda").manual_seed(5)
    for side in HBM_SIDES:
        p = csr_plan(*lattice_edges(side)[1:], side * side).to("cuda")
        n, e, nnz = p.num_nodes, p.col.numel(), p.num_edges
        w = torch.rand(e, device="cuda", generator=gen)
        w_t = w.index_select(0, p.t_order).contiguous()
        a_csr = csr_tensor(p.row_ptr, p.col, w)
        at_csr = csr_tensor(p.t_row_ptr, p.t_col, w_t)
        a_pat = csr_tensor(p.row_ptr, p.col, torch.zeros_like(w))
        print(f"[hbm] {side} x {side} lattice: N={n} E={e} real edges={nnz} "
              f"F={f}", flush=True)
        g = torch.randn(n, f, device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(n, f, device="cuda", generator=gen).to(dtype)
            sz = x.element_size()
            f32 = dtype == torch.float32
            xt = x.t().contiguous()
            # (name, role, kernel, plain version, their arguments, bytes,
            # operations, library call, its arguments, plan)
            runs = [
                ("csr_spmm", "forward", csr_spmm, csr_spmm_plain,
                 (x, p.row_ptr, p.col, w),
                 n * f * sz + (n + 1) * 4 + nnz * 8 + n * f * 4,
                 2.0 * nnz * f, torch.sparse.mm, (a_csr, x),
                 csr_spmm_plan(f, dtype)),
                ("csr_spmm", "transpose", csr_spmm, csr_spmm_plain,
                 (x, p.t_row_ptr, p.t_col, w, p.t_order),
                 n * f * sz + (n + 1) * 4 + nnz * 16 + n * f * 4,
                 2.0 * nnz * f, torch.sparse.mm, (at_csr, x),
                 csr_spmm_plan(f, dtype)),
                ("edge_sddmm", "dw", edge_sddmm, edge_sddmm_plain,
                 (x, g, p.row, p.col, nnz),
                 n * f * sz + n * f * 4 + nnz * 8 + e * 4,
                 2.0 * nnz * f,
                 lambda a, g, xt: torch.sparse.sampled_addmm(a, g, xt,
                                                             beta=0.0),
                 (a_pat, g, xt), edge_sddmm_plan(f, dtype)),
            ]
            for (name, role, kern, plain, args, nbytes, ops, lib, lib_args,
                 plan) in runs:
                out, ref = kern(*args), plain(*args)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                tol = (1e-5 if f32 else 1e-4) * max(float(ref.abs().max()),
                                                    1e-6)
                if not out.isfinite().all() or err > tol:
                    fail(f"{name} {role} N={n} {dtype}: max |err| {err:.3e} "
                         f"> tolerance {tol:.3e}")
                lib_ms, why = None, "float32 only"
                if f32:
                    lib_out = lib(*lib_args)
                    if lib_out.layout != torch.strided:   # sampled_addmm
                        lib_out = lib_out.values()
                        ref_cmp = csr_values_of(p, ref)
                    else:
                        ref_cmp = ref
                    lib_err = float((lib_out - ref_cmp).abs().max())
                    if lib_err > tol:
                        fail(f"{name} {role} N={n} library call: max |err| "
                             f"{lib_err:.3e} > tolerance {tol:.3e}")
                    lib_ms, why = library_ms(rotating(lib, *lib_args))
                b_ms, b_by = bound_ms(nbytes, ops)
                # Cold L2 (the bound's premise), and warm beside it.
                k_ms, k_host = time_ms(rotating(kern, *args))
                warm_ms, _ = time_ms(lambda: kern(*args))
                p_ms, _ = time_ms(rotating(plain, *args))
                print(f"[hbm] {name:10s} {role:9s} N={n:5d} F={f} "
                      f"{str(dtype).replace('torch.', ''):8s} err {err:.2e} "
                      f"(tol {tol:.1e}) device, cold L2: kernel "
                      f"{k_ms * 1e3:7.2f} us  plain {p_ms * 1e3:8.2f} us  "
                      f"bound {b_ms * 1e3:5.2f} us ({b_by})  library "
                      + (f"{lib_ms * 1e3:7.2f} us" if lib_ms is not None
                         else f"n/a ({why})")
                      + f"; kernel warm L2 {warm_ms * 1e3:7.2f} us; host a "
                      f"call {k_host * 1e3:6.2f} us; plan {plan.label()}",
                      flush=True)
                if (name, n, f32) == ("edge_sddmm", HBM_SIDES[0] ** 2, True):
                    print(f"[hbm] edge_sddmm N={n} F={f} float32 (B4c): cold "
                          f"{k_ms * 1e3:.2f} us against half its bound's "
                          f"target {2 * b_ms * 1e3:.2f} us: "
                          + ("met" if k_ms <= 2 * b_ms else "NOT met"),
                          flush=True)


def csr_values_of(p, dots):
    """Per-edge values [E] (real edges first, in the plan's edge order) in
    the value order of :func:`csr_tensor`'s matrix (columns sorted within
    each row)."""
    import torch
    n, nnz = p.num_nodes, p.num_edges
    rows = torch.repeat_interleave(torch.arange(n, device=p.row_ptr.device),
                                   (p.row_ptr[1:] - p.row_ptr[:-1]).long())
    return dots[:nnz][torch.argsort(rows * n + p.col[:nnz].long())]


def hscn_data(path: Path):
    """(cfg, dm) of an HSCN config, each graph's cluster ids drawn from a
    seeded generator (an HSCN step's shapes and work do not depend on
    them)."""
    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.data.pipeline import DataModule

    cfg = load_config(path)
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    rng = np.random.default_rng(0)
    k = cfg.hscn.num_clusters
    dm.graphs = [g.replace(cluster=rng.integers(0, k, g.num_nodes).astype(
        np.int32)) for g in dm.graphs]
    return cfg, dm


def check_spmm_batch(label: str, p, w, cases) -> None:
    """csr_spmm (B1) on one batch's CSR plan ``p`` with the edge weights
    ``w`` [E] its model gives the kernel: each (role, F) of ``cases``,
    float32, role "forward" or "transpose" (the weights read in t_order by
    the kernel), against its plain version (1e-5 * max|ref|), with its
    launch plan, timed cold (``rotating``) with the warm time beside, its
    bound, the plain version's and torch.sparse.mm's times."""
    import torch

    from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import (csr_spmm,
                                                           csr_spmm_plain,
                                                           csr_spmm_plan)

    n, nnz = p.num_nodes, p.num_edges
    a_csr = csr_tensor(p.row_ptr, p.col, w)
    at_csr = csr_tensor(p.t_row_ptr, p.t_col, w.index_select(0, p.t_order))
    gen = torch.Generator(device="cuda").manual_seed(8)
    for role, f in cases:
        x = torch.randn(n, f, device="cuda", generator=gen)
        if role == "forward":
            args = (x, p.row_ptr, p.col, w)
            nbytes = n * f * 4 + (n + 1) * 4 + nnz * 8 + n * f * 4
            lib_args = (a_csr, x)
        else:
            args = (x, p.t_row_ptr, p.t_col, w, p.t_order)
            nbytes = n * f * 4 + (n + 1) * 4 + nnz * 16 + n * f * 4
            lib_args = (at_csr, x)
        out, ref = csr_spmm(*args), csr_spmm_plain(*args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        tol = 1e-5 * max(float(ref.abs().max()), 1.0)
        if not out.isfinite().all() or err > tol:
            fail(f"csr_spmm {label} {role} F={f}: max |err| {err:.3e} > "
                 f"tolerance {tol:.3e}")
        lib_ms, why = library_ms(rotating(torch.sparse.mm, *lib_args))
        b_ms, b_by = bound_ms(nbytes, 2.0 * nnz * f)
        k_ms, k_host = time_ms(rotating(csr_spmm, *args))
        warm_ms, _ = time_ms(lambda a=args: csr_spmm(*a))
        p_ms, _ = time_ms(rotating(csr_spmm_plain, *args))
        print(f"[kernels] {label} csr_spmm {role:9s} F={f} float32 err "
              f"{err:.2e} (tol {tol:.1e}) device, cold L2: kernel "
              f"{k_ms * 1e3:7.2f} us ({b_ms / k_ms:.2f} of bound)  plain "
              f"{p_ms * 1e3:7.2f} us  bound {b_ms * 1e3:5.2f} us ({b_by})  "
              "library (torch.sparse.mm) "
              + (f"{lib_ms * 1e3:7.2f} us" if lib_ms is not None
                 else f"n/a ({why})")
              + f"; kernel warm L2 {warm_ms * 1e3:7.2f} us; host a call "
              f"{k_host * 1e3:6.2f} us; plan "
              f"{csr_spmm_plan(f, torch.float32).label()}", flush=True)


def phase_hscn_kernels() -> None:
    """csr_spmm (B1) at the VOC sparse HSCN batch, the width of its ll
    GCNConv (F = hidden 32, gcn-normalized weights without self loops):
    the forward and the transpose (``check_spmm_batch``)."""
    from graph_hscn_tpu_torch.ops.spmm import gcn_norm_weights

    cfg, dm = hscn_data(VOC_HSCN)
    dm.with_spmm_plan = True    # the first train batch, as the fit packs it
    b = next(iter(dm.train_batches(epoch_seed=dm.seed))).to("cuda")
    p = b.spmm
    f = cfg.hscn.hidden_channels
    w, _ = gcn_norm_weights(b.senders, b.receivers, b.edge_mask,
                            p.num_nodes, add_self_loops=False)
    print(f"[kernels] VOC HSCN batch: N={p.num_nodes} E={p.col.numel()} "
          f"real edges={p.num_edges} graphs={b.num_graphs_padded} F={f}",
          flush=True)
    check_spmm_batch("VOC HSCN", p, w, [("forward", f), ("transpose", f)])


def phase_gin_kernels() -> None:
    """csr_spmm (B1) at the peptides GIN batch on sparse batches (the
    first train batch of ``GIN`` with ``GIN_SPARSE``, as the fit packs it,
    with its CSR plan), with the weights GINConv gives it (the 0/1 edge
    mask): the forward at layer 0's width (the node features) and at the
    hidden width, and the transpose at the hidden width (the dx of layers
    1 and 2; layer 0's input takes no gradient), each
    ``check_spmm_batch``."""
    import torch

    from graph_hscn_tpu_torch.data.pipeline import DataModule

    cfg = load_with(GIN, GIN_SPARSE)
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    dm.with_spmm_plan = True
    b = next(iter(dm.train_batches(epoch_seed=dm.seed))).to("cuda")
    p = b.spmm
    w = torch.where(b.edge_mask, 1.0, 0.0)
    f = cfg.mpnn.hidden_channels
    print(f"[kernels] peptides GIN sparse batch: N={p.num_nodes} "
          f"E={p.col.numel()} real edges={p.num_edges} "
          f"graphs={b.num_graphs_padded} F={dm.num_features}, {f}",
          flush=True)
    check_spmm_batch("peptides GIN", p, w,
                     [("forward", dm.num_features), ("forward", f),
                      ("transpose", f)])


def load_with(path: Path, changes: dict | None = None):
    """The config at ``path`` with ``changes`` ({"section.field": value})
    set."""
    from graph_hscn_tpu_torch.config.config import load_config
    cfg = load_config(path)
    for key, value in (changes or {}).items():
        section, field = key.split(".")
        setattr(getattr(cfg, section), field, value)
    return cfg


def fused_setup():
    """(cfg, dm, ds, model) of the fused peptides config at full width: the
    data with dense slots, the device-resident dataset of all its graphs on
    the card, and the FusedDenseGCN the runner builds (weights from seed
    0)."""
    import torch

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.models.fused_gcn import FusedDenseGCN
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    from graph_hscn_tpu_torch.train.device_data import DeviceDataset

    cfg = load_config(PEPTIDES_FUSED)
    set_matmul_precision(cfg.runtime.matmul_precision)
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    if not dm.enable_dense_slots():
        fail(f"{PEPTIDES_FUSED.name}: the graphs do not fit dense slots")
    ds = DeviceDataset.build(dm.graphs, slot=dm.slot_nodes, device="cuda")
    model = FusedDenseGCN(dm.num_features, cfg.mpnn.hidden_channels,
                          dm.num_classes, cfg.mpnn.num_layers,
                          dropout=cfg.mpnn.dropout,
                          generator=torch.Generator().manual_seed(0))
    return cfg, dm, ds, model.cuda()


def fused_bound(G: int, S: int, dims: list, esize: int, direction: str,
                bits: bool) -> tuple[float, str]:
    """The least time of one fused-stack call: each input read once and
    each output written once, against the float32 FMA rate (no tensor
    cores under matmul_precision highest)."""
    L = len(dims) - 1
    hidden = sum(G * S * f for f in dims[1:-1])
    params = (sum(dims[l] * dims[l + 1] for l in range(L)) * esize
              + sum(dims[1:]) * 4)
    base = G * S * S * esize + G * S * dims[0] * esize + params
    mac_a = sum(G * S * S * dims[l + 1] for l in range(L))
    mac_w = sum(G * S * dims[l] * dims[l + 1] for l in range(L))
    if direction == "fwd":
        nbytes = (base + hidden * esize + G * S * dims[-1] * 4
                  + (hidden * 4 if bits else 0))
        ops = 2 * (mac_a + mac_w)
    else:   # acts and g in; dx, dW and db out
        nbytes = (base + hidden * esize + G * S * dims[-1] * 4
                  + G * S * dims[0] * esize
                  + sum(dims[l] * dims[l + 1] + dims[l + 1]
                        for l in range(L)) * 4)
        ops = 2 * (mac_a + 2 * mac_w)
    return bound_ms(nbytes, ops)


def fused_error(label: str, got, ref, f32: bool) -> float:
    """The fused kernels' criterion, as tests/test_torch_cuda.py applies it:
    ``got`` finite and max |got - ref| <= tol * max|ref|, tol 1e-5 in
    float32 and 1e-4 in bfloat16, ``ref`` from the plain version as
    ops/fused_gcn.py:plain_reference runs it.  Fails the run otherwise;
    returns the error over tol."""
    tol = (1e-5 if f32 else 1e-4) * max(float(ref.float().abs().max()), 1e-6)
    err = float((got.float() - ref.float()).abs().max())
    if not got.isfinite().all() or err > tol:
        fail(f"{label}: max |err| {err:.3e} > tolerance {tol:.3e}")
    return err / tol


def cublas_sums_in_order(a_hat, y, w) -> tuple[bool, bool]:
    """Whether cuBLAS, in the plain versions, sums in the kernels' order on
    these operands (rounded to bfloat16, whose products are exact): the
    A_hat products (torch.bmm, A_hat y and A_hat^T y) and the small ones
    (torch.matmul, y w), each bit for bit against ProductsInOrder."""
    import torch

    from graph_hscn_tpu_torch.ops.fused_gcn import ProductsInOrder
    a, y, w = (t.to(torch.bfloat16).float() for t in (a_hat, y, w))
    pairs = [(torch.bmm, a, y), (torch.bmm, a.transpose(1, 2), y),
             (torch.matmul, y, w)]
    same = []
    for fn, u, v in pairs:
        with ProductsInOrder():
            in_order = fn(u, v)
        same.append(torch.equal(fn(u, v), in_order))
    return same[0] and same[1], same[2]


def fused_plans(G: int, S: int, dims: list) -> None:
    """Print both kernels' launch plans for a shape, each with how many of
    its clusters the card holds at once."""
    import torch

    from graph_hscn_tpu_torch.ops.fused_gcn import (fused_plan,
                                                    max_active_clusters)
    for dtype in (torch.float32, torch.bfloat16):
        for backward in (False, True):
            plan = fused_plan(G, S, dims, dtype, backward)
            n = max_active_clusters(plan, dtype, backward)
            print(f"[fused] plan {'bwd' if backward else 'fwd'} "
                  f"{str(dtype).replace('torch.', ''):8s} G={G} S={S} "
                  f"widths {dims}: clusters of {plan.cluster} ({plan.blocks} "
                  f"blocks), {plan.rows} "
                  f"{'columns' if backward else 'rows'} a block, A_hat "
                  f"{'resident' if plan.resident else 'streamed'}, jt "
                  f"{plan.jt}, fc {plan.fc}, {plan.smem} shared bytes a "
                  f"block; cudaOccupancyMaxActiveClusters {n}", flush=True)


FUSED_WIDE = ((32, 512, [9, 128, 128, 128, 128, 10], True),
              (2, 1024, [64, 16, 10], False))


def phase_fused_wide(shapes=FUSED_WIDE, dtypes=None,
                     kinds=("none", "bits", "seed"), tag: str = "[fused]"):
    """Both fused kernels against their plain versions at two more plans:
    S=512, hidden 128, 5 layers (configs/GCN/peptides_func_GCN_dp8.yaml's
    widths on the largest dense slot, G=32), and S=1024 with an input
    width of 64 (G=2), whose A_hat slice is streamed in tiles and whose x
    the forward reads from global memory; random graphs of ~2 edges a
    node, float32 and bfloat16, all three dropout modes; the backward
    twice, equal bit for bit.  Prints the first shape's float32 seeded
    warm times, the plain versions' beside.  ``shapes`` ((G, S, widths,
    timed), ...), ``dtypes`` (default float32 and bfloat16), ``kinds`` and
    the lines' ``tag`` for another path's shapes."""
    import torch

    from graph_hscn_tpu_torch.ops.fused_gcn import (folded_operator,
                                                    fused_gcn_bwd,
                                                    fused_gcn_bwd_plain,
                                                    fused_gcn_fwd,
                                                    fused_gcn_fwd_plain,
                                                    plain_reference)
    for G, S, dims, timed in shapes:
        fused_plans(G, S, dims)
        gen = torch.Generator(device="cuda").manual_seed(6)
        adj = torch.rand(G, S, S, device="cuda", generator=gen) < 2.0 / S
        adj = (adj | adj.transpose(1, 2)).float()
        g_out = torch.randn(G, S, dims[-1], device="cuda", generator=gen)
        for dtype in dtypes or (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            name = str(dtype).replace("torch.", "")
            a_hat = folded_operator(adj).to(dtype).contiguous()
            x = torch.randn(G, S, dims[0], device="cuda",
                            generator=gen).to(dtype)
            ws = [(0.15 * torch.randn(dims[i], dims[i + 1], device="cuda",
                                      generator=gen)).to(dtype)
                  for i in range(len(dims) - 1)]
            bs = [0.1 * torch.randn(f, device="cuda", generator=gen)
                  for f in dims[1:]]
            bits = [torch.randint(-2 ** 31, 2 ** 31, (G, S, f),
                                  device="cuda", dtype=torch.int32,
                                  generator=gen) for f in dims[1:-1]]
            for kind in kinds:
                r = 0.0 if kind == "none" else 0.1
                drop = {"none": None, "bits": {"bits": bits},
                        "seed": {"seed": FUSED_SEED}}[kind]
                outs = fused_gcn_fwd(a_hat, x, ws, bs, r, drop)
                refs = plain_reference(fused_gcn_fwd_plain, a_hat, x, ws, bs,
                                       r, drop)
                acts = refs[:-1]
                back = fused_gcn_bwd(a_hat, x, ws, acts, g_out, r)
                again = fused_gcn_bwd(a_hat, x, ws, acts, g_out, r)
                back_ref = plain_reference(fused_gcn_bwd_plain, a_hat, x, ws,
                                           acts, g_out, r)
                torch.cuda.synchronize()
                got = [back[0]] + back[1] + back[2]
                if not all(torch.equal(a, b) for a, b in
                           zip(got, [again[0]] + again[1] + again[2])):
                    fail(f"fused_gcn_bwd {name} S={S} widths {dims}: two "
                         "calls differ")
                ratio = max(fused_error(
                    f"fused S={S} widths {dims} {name} dropout {kind}", o, w,
                    f32) for o, w in zip(
                        outs + got,
                        refs + [back_ref[0]] + back_ref[1] + back_ref[2]))
                rounded = all(torch.equal(o, w) for o, w in
                              zip(outs + got[:1], refs + [back_ref[0]]))
                line = (f"{tag} G={G} S={S} widths {dims} {name:8s} dropout "
                        f"{kind:4s}: forward and backward within "
                        f"{ratio:.3f} of tol {1e-5 if f32 else 1e-4:.0e}"
                        f"*max|ref|; outputs and dx bit for bit: {rounded}; "
                        "backward bit-identical twice")
                if timed and f32 and kind == "seed":
                    fwd_ms, _ = time_ms(lambda: fused_gcn_fwd(
                        a_hat, x, ws, bs, r, drop))
                    bwd_ms, _ = time_ms(lambda: fused_gcn_bwd(
                        a_hat, x, ws, acts, g_out, r))
                    fwd_plain, _ = time_ms(lambda: fused_gcn_fwd_plain(
                        a_hat, x, ws, bs, r, drop))
                    bwd_plain, _ = time_ms(lambda: fused_gcn_bwd_plain(
                        a_hat, x, ws, acts, g_out, r))
                    fb, fby = fused_bound(G, S, dims, 4, "fwd", False)
                    bb, bby = fused_bound(G, S, dims, 4, "bwd", False)
                    line += (f"; device warm: fwd {fwd_ms * 1e3:.2f} us "
                             f"(bound {fb * 1e3:.2f}, {fby}; plain "
                             f"{fwd_plain * 1e3:.2f}), bwd "
                             f"{bwd_ms * 1e3:.2f} us (bound "
                             f"{bb * 1e3:.2f}, {bby}; plain "
                             f"{bwd_plain * 1e3:.2f})")
                print(line, flush=True)


def phase_fused_kernels(build_logs: dict):
    """The fused GCN stack's two kernels at the peptides batch shape,
    against their plain versions, timed warm (the same inputs call after
    call, as in a train step that has just folded A_hat) and cold (input
    copies spanning 4x the L2); then at two more plans
    (:func:`phase_fused_wide`).  Returns their records."""
    import torch

    from graph_hscn_tpu_torch.models.layers import GCNConv
    from graph_hscn_tpu_torch.ops.fused_gcn import (dropout_bits_plain,
                                                    dropout_threshold,
                                                    folded_operator,
                                                    fused_gcn_bwd,
                                                    fused_gcn_bwd_plain,
                                                    fused_gcn_fwd,
                                                    fused_gcn_fwd_plain,
                                                    plain_reference)
    from graph_hscn_tpu_torch.train.device_data import assemble

    for name in ("fused_gcn_fwd", "fused_gcn_bwd"):
        for line in build_logs.get(name, "").strip().splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"[fused] {name} ptxas: {line.strip()}")
    cfg, dm, ds, model = fused_setup()
    G, S = cfg.data.batch_size, ds.slot
    idx = torch.as_tensor(dm.split_idx["train"][:G], dtype=torch.int32,
                          device="cuda")
    batch = assemble(ds, idx)
    adj = batch.dense_adj
    x32 = batch.node_feat.reshape(G, S, -1)
    params = model.params()
    dims = [x32.shape[-1]] + [p["kernel"].shape[1] for p in params]
    rate = float(cfg.mpnn.dropout)
    thr = dropout_threshold(rate)
    gen = torch.Generator(device="cuda").manual_seed(1)
    g_out = torch.randn(G, S, dims[-1], device="cuda", generator=gen)
    bits = [torch.randint(-2 ** 31, 2 ** 31, (G, S, f), dtype=torch.int32,
                          device="cuda", generator=gen) for f in dims[1:-1]]
    seed_dev = torch.tensor([FUSED_SEED], dtype=torch.int64, device="cuda")
    print(f"[fused] peptides batch: G={G} S={S} widths {dims}, "
          f"{int(adj.sum())} edges, {int(batch.node_mask.sum())} nodes",
          flush=True)
    fused_plans(G, S, dims)
    bmm_order, matmul_order = cublas_sums_in_order(
        folded_operator(adj), g_out, params[-1]["kernel"].detach().t())
    print(f"[fused] cuBLAS sums in the kernels' order at this batch "
          f"(bfloat16 operands, bit for bit): A_hat products {bmm_order}, "
          f"small products {matmul_order}", flush=True)
    cases = []
    worst = {"fused_gcn_fwd": 0.0, "fused_gcn_bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        a_hat = folded_operator(adj).to(dtype).contiguous()
        x = x32.to(dtype).contiguous()
        ws = [p["kernel"].detach().to(dtype).contiguous() for p in params]
        bs = [p["bias"].detach().float().contiguous() for p in params]
        # bf16: the reference sums in the kernels' order, so the same
        # rounding points give the same bf16 values; a kernel without one
        # of them fails 1e-4 (tests/test_torch_fused_gcn.py
        # test_bf16_tolerance_catches_a_missing_rounding_point).
        tol_rel = 1e-5 if f32 else 1e-4
        for kind in ("none", "bits", "seed"):
            r = 0.0 if kind == "none" else rate
            d_kernel = {"none": None, "bits": {"bits": bits},
                        "seed": {"seed": seed_dev}}[kind]
            d_plain = {"none": None, "bits": {"bits": bits},
                       "seed": {"seed": FUSED_SEED}}[kind]
            outs = fused_gcn_fwd(a_hat, x, ws, bs, r, d_kernel)
            refs = plain_reference(fused_gcn_fwd_plain, a_hat, x, ws, bs, r,
                                   d_plain)
            acts = refs[:-1]
            back = fused_gcn_bwd(a_hat, x, ws, acts, g_out, r)
            back_ref = plain_reference(fused_gcn_bwd_plain, a_hat, x, ws,
                                       acts, g_out, r)
            torch.cuda.synchronize()
            errs, ratios = {}, {}
            for name, got, want in (
                    ("fused_gcn_fwd", outs, refs),
                    ("fused_gcn_bwd", [back[0]] + back[1] + back[2],
                     [back_ref[0]] + back_ref[1] + back_ref[2])):
                e = ratio = 0.0
                for o, w in zip(got, want):
                    ratio = max(ratio, fused_error(
                        f"{name} {dtype} dropout {kind}", o, w, f32))
                    e = max(e, float((o.float() - w.float()).abs().max()))
                errs[name], ratios[name] = e, ratio
                if f32:
                    worst[name] = max(worst[name], e)
            if kind == "seed":
                for l, h in enumerate(outs[:-1]):
                    b = dropout_bits_plain(FUSED_SEED, G, S, h.shape[-1], l,
                                           "cuda")
                    dropped = b < thr
                    if h[dropped].any():
                        fail(f"fused_gcn_fwd {dtype}: an element the Philox "
                             "bits drop is not 0")
                    share = float(dropped.float().mean())
                    if abs(share - rate) > 0.01:
                        fail(f"seeded dropout drops {share:.4f}, rate {rate}")
            again = fused_gcn_bwd(a_hat, x, ws, acts, g_out, r)
            if not all(torch.equal(a, b) for a, b in zip(
                    [back[0]] + back[1] + back[2],
                    [again[0]] + again[1] + again[2])):
                fail(f"fused_gcn_bwd {dtype} dropout {kind}: two calls "
                     "differ")
            esize = x.element_size()
            n_bits = len(bits) if kind == "bits" else 0

            def fwd_cold(a, xx, *bb, r=r, d=d_kernel):
                """The forward on copied inputs (given bits copied too)."""
                return fused_gcn_fwd(a, xx, ws, bs, r,
                                     {"bits": list(bb)} if bb else d)

            def bwd_cold(a, xx, gg, *hh, r=r):
                return fused_gcn_bwd(a, xx, ws, list(hh), gg, r)

            for name, kern, cold, plain in (
                    ("fused_gcn_fwd",
                     lambda: fused_gcn_fwd(a_hat, x, ws, bs, r, d_kernel),
                     rotating(fwd_cold, a_hat, x, *bits[:n_bits]),
                     lambda: fused_gcn_fwd_plain(a_hat, x, ws, bs, r,
                                                 d_plain)),
                    ("fused_gcn_bwd",
                     lambda: fused_gcn_bwd(a_hat, x, ws, acts, g_out, r),
                     rotating(bwd_cold, a_hat, x, g_out, *acts),
                     lambda: fused_gcn_bwd_plain(a_hat, x, ws, acts, g_out,
                                                 r))):
                direction = name[-3:]
                b_ms, b_by = fused_bound(G, S, dims, esize, direction,
                                         kind == "bits")
                k_ms, k_host = time_ms(kern)
                cold_ms, _ = time_ms(cold)
                p_ms, _ = time_ms(plain)
                case = dict(name=name, dtype=str(dtype).replace("torch.", ""),
                            dropout=kind, max_abs_err=errs[name],
                            ms=k_ms, cold_ms=cold_ms, plain_ms=p_ms,
                            library_ms=None, bound_ms=b_ms, bound_by=b_by)
                cases.append(case)
                print(f"[fused] {name} {case['dtype']:8s} dropout "
                      f"{kind:4s} err {errs[name]:.2e} ({ratios[name]:.3f} "
                      f"of tol {tol_rel:.0e}*max|ref| an output) device: "
                      f"kernel warm {k_ms * 1e3:8.2f} us, cold L2 "
                      f"{cold_ms * 1e3:8.2f} us  plain {p_ms * 1e3:8.2f} us"
                      f"  bound {b_ms * 1e3:6.2f} us ({b_by}); host a call "
                      f"{k_host * 1e3:6.2f} us", flush=True)
    # Yardstick: the unfused dense stack, the MPNN's torch.bmm route, at the
    # same shape in float32 (forward without dropout, and forward+backward).
    convs = []
    for p in params:
        conv = GCNConv(p["kernel"].shape[0], p["kernel"].shape[1]).cuda()
        with torch.no_grad():
            conv.weight.copy_(p["kernel"].t())
            conv.bias.copy_(p["bias"])
        convs.append(conv)
    adj_n, diag = GCNConv.normalize_dense(adj)
    xf = batch.node_feat
    g_flat = g_out.reshape(G * S, -1)

    def dense_stack():
        h = xf
        for i, conv in enumerate(convs):
            h = conv(h, None, None, None, num_nodes=G * S, dense_adj=adj_n,
                     dense_diag=diag)
            if i < len(convs) - 1:
                h = torch.relu(h)
        return h

    with torch.no_grad():
        y_fwd, _ = time_ms(dense_stack)
    y_both, _ = time_ms(lambda: dense_stack().backward(g_flat))
    print(f"[fused] yardstick, unfused dense stack (torch.bmm, float32): "
          f"forward {y_fwd * 1e3:.2f} us, forward+backward "
          f"{y_both * 1e3:.2f} us (backward {1e3 * (y_both - y_fwd):.2f} us "
          "by difference); no single library call computes the fused "
          "function", flush=True)
    records = {c["name"]: c for c in cases
               if (c["dtype"], c["dropout"]) == ("float32", "seed")}
    for name, c in records.items():
        fwd = name == "fused_gcn_fwd"
        yard = y_fwd if fwd else y_both - y_fwd
        print(f"[fused] {name} float32 seeded dropout: warm "
              f"{c['ms'] * 1e3:.2f} us, cold {c['cold_ms'] * 1e3:.2f} us; "
              f"the yardstick's {'forward' if fwd else 'backward'} "
              f"{yard * 1e3:.2f} us: "
              + ("faster" if max(c["ms"], c["cold_ms"]) < yard
                 else "NOT faster"), flush=True)
    phase_fused_wide()
    src = "graph_hscn_tpu_torch/csrc/{}.cu"
    pallas = "graph_hscn_tpu/ops/pallas/fused_gcn_kernel.py:{}"
    return [
        {"name": "fused_gcn_fwd", "route": "cuda",
         "source": src.format("fused_gcn_fwd"), "replaces": pallas.format(51),
         **_timing(records["fused_gcn_fwd"], worst["fused_gcn_fwd"])},
        {"name": "fused_gcn_bwd", "route": "cuda",
         "source": src.format("fused_gcn_bwd"),
         "replaces": pallas.format(103),
         **_timing(records["fused_gcn_bwd"], worst["fused_gcn_bwd"])},
    ]


def one_rank_mesh(axes=("data",)):
    """A mesh of one rank on the card, with no process group: enough to
    pack and plan a block as that rank's fit does (the kernels take no
    collective)."""
    import torch

    from graph_hscn_tpu_torch.parallel.mesh import Mesh
    return Mesh(tuple(axes), (1,) * len(axes), 0, 1, None,
                torch.device("cuda"), coords=(0,) * len(axes))


def phase_edge_partition_kernels() -> None:
    """[edge_partition] csr_spmm (B1) and spmm_mh / sddmm_mh (B6, B7) at
    the edge-partition block: the train split of ``GCN_EP`` packed,
    locality-reordered and planned as fit_edge_partitioned does on one
    rank (its local-edge CsrPlan), on the card.  csr_spmm forward and
    transpose at F = 64 with random weights on the block's edge slots
    (``check_spmm_batch``); spmm_mh forward and transpose and sddmm_mh (d
    alpha) at H = 4, C = 16 and 21, float32 (``time_case``, each held at
    1e-5 * max|ref|); segment_reduce (B5) at the GatedGCN config's block
    and csr_spmm at the HSCN config's."""
    import torch

    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.parallel.sharded_gcn import partition_split

    mesh = one_rank_mesh()
    cfg = load_with(GCN_EP)
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    split = partition_split(dm.split("train"), mesh,
                            cfg.mesh.locality_reorder, use_plan=True)
    p, i = split.block.csr, split.info
    print(f"[edge_partition] block: N_b={i['block_rows']} rows, "
          f"E={i['edges']} real edges ({p.col.numel()} slots with "
          f"padding), H={i['halo_width']}, host plan "
          f"{i['seconds']:.3f} s", flush=True)
    check_spmm_batch("edge-partition block", p,
                     torch.rand(p.col.numel(), device="cuda"),
                     [("forward", cfg.mpnn.hidden_channels),
                      ("transpose", cfg.mpnn.hidden_channels)])
    for case in gat_cases(p):
        if case["c"] in (16, 21) and case["dtype"] == "float32":
            time_case("[edge_partition]", case)
    # The GAT step's attention gathers are stock index_select over the
    # block's edges: their time at its two row widths, as a yardstick.
    gen = torch.Generator(device="cuda").manual_seed(9)
    snd = p.col.long()
    for f in (4, cfg.mpnn.hidden_channels):
        x = torch.randn(p.num_nodes, f, device="cuda", generator=gen)
        g_ms, _ = time_ms(rotating(torch.index_select, x, 0, snd))
        b_ms, _ = bound_ms(snd.numel() * (8 + 4 * f) + x.numel() * 4, 0)
        print(f"[edge_partition] yardstick: index_select of [{p.num_nodes},"
              f" {f}] float32 rows by the block's {snd.numel()} senders: "
              f"{g_ms * 1e3:.2f} us cold (bound {b_ms * 1e3:.2f} us, "
              "bytes)", flush=True)
    # segment_reduce (B5) at the GatedGCN config's train block: the local
    # sums (receiver side) and the local gathers' backwards (sender side,
    # t_order), F = hidden, float32.
    gcfg = load_with(GATED_EP)
    gdm = DataModule.from_config(gcfg.data,
                                 pad_safety=gcfg.runtime.pad_safety)
    split = partition_split(gdm.split("train"), mesh,
                            gcfg.mesh.locality_reorder, use_plan=True,
                            edges=True)
    p, i = split.block.csr, split.info
    print(f"[edge_partition] GatedGCN block: N_b={i['block_rows']} rows,"
          f" {p.num_edges} local edges ({p.col.numel()} slots), "
          f"F={gcfg.mpnn.hidden_channels}", flush=True)
    msgs = torch.randn(p.col.numel(), gcfg.mpnn.hidden_channels,
                       device="cuda", generator=gen)
    for side, rp, order in (("receiver", p.row_ptr, None),
                            ("sender", p.t_row_ptr, p.t_order)):
        segment_reduce_case("[edge_partition] GatedGCN block", side, msgs,
                            rp, order, p.num_edges)
    del split, msgs
    # csr_spmm (B1) at the HSCN config's train block, F = hidden, random
    # weights on its edge slots.
    hcfg = load_with(HSCN_EP)
    hdm = DataModule.from_config(hcfg.data,
                                 pad_safety=hcfg.runtime.pad_safety)
    split = partition_split(hdm.split("train"), mesh,
                            hcfg.mesh.locality_reorder, use_plan=True)
    p = split.block.csr
    print(f"[edge_partition] HSCN block: N_b={split.info['block_rows']} "
          f"rows, {p.num_edges} local edges", flush=True)
    check_spmm_batch("edge-partition HSCN block", p,
                     torch.rand(p.col.numel(), device="cuda"),
                     [("forward", hcfg.hscn.hidden_channels),
                      ("transpose", hcfg.hscn.hidden_channels)])


def dp_global_batches(dm, split: str, seed: int | None):
    """fit_dp's global batches of ``split`` at one rank (shuffled with
    ``seed``, None: in order), packed as one batch each."""
    from graph_hscn_tpu_torch.data.batching import PadBudget
    from graph_hscn_tpu_torch.parallel.data_parallel import pack_for_devices
    graphs = dm.split(split)
    idx = np.arange(len(graphs))
    if seed is not None:
        np.random.default_rng(seed).shuffle(idx)
    budget = PadBudget.for_dataset(dm.graphs, dm.batch_size)
    for i in range(0, len(idx), dm.batch_size):
        chunk = [graphs[int(j)] for j in idx[i:i + dm.batch_size]]
        yield pack_for_devices(chunk, 1, budget, slot_nodes=dm.slot_nodes,
                               with_spmm_plan=dm.with_spmm_plan)[0]


def phase_dp_kernels() -> None:
    """[dp] csr_spmm (B1) at the first global batch of
    configs/GCN/peptides_func_GCN_dp8.yaml on sparse batches, as fit_dp
    packs it at one rank (F = 128 and 10, forward and transpose, the GCN
    weights), and the fused kernels (B2f, B2b) at its dense shape (G =
    128, slot 392, hidden 128, 5 layers), against their plain versions."""
    import torch

    from graph_hscn_tpu_torch.ops.spmm import gcn_norm_weights
    from graph_hscn_tpu_torch.runner import _data
    from graph_hscn_tpu_torch.utils.logger import Logger

    one = {"mesh.shape": [1]}
    cfg = load_with(DP8, {**one, "runtime.dense_path": "sparse"})
    dm = _data(cfg, torch.device("cuda"), Logger(quiet=True))
    b = next(dp_global_batches(dm, "train", cfg.training.seed)).to("cuda")
    p = b.spmm
    w, _ = gcn_norm_weights(b.senders, b.receivers, b.edge_mask,
                            p.num_nodes)
    print(f"[dp] sparse batch: N={p.num_nodes} E={p.col.numel()} real "
          f"edges={p.num_edges} graphs={b.num_graphs_padded - 1}",
          flush=True)
    check_spmm_batch("dp sparse batch", p, w,
                     [("forward", 128), ("transpose", 128), ("forward", 10),
                      ("transpose", 10)])
    slot = _data(load_with(DP8, one), torch.device("cuda"),
                 Logger(quiet=True)).slot_nodes
    phase_fused_wide(((cfg.data.batch_size, slot,
                       [9, 128, 128, 128, 128, 10], True),),
                     dtypes=(torch.float32,), kinds=("none", "seed"),
                     tag="[dp] fused")


def phase_hybrid_kernels() -> None:
    """[hybrid] csr_spmm (B1, F = 64, forward and transpose, random weights
    on the block's edge slots) and spmm_mh / sddmm_mh (B6/B7 at the hybrid
    GAT's one head, C = 64) at configs/GCN/voc_superpixels_GCN_hybrid.yaml's
    train block on a (1, 1) mesh, against their plain versions."""
    import torch

    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.parallel.hybrid import (build_hybrid_split,
                                                      hybrid_block)

    cfg = load_with(HYBRID)
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    t0 = time.perf_counter()
    plan, x, y, ok, meta = build_hybrid_split(dm.split("train"), 1, 1,
                                              cfg.mesh.locality_reorder)
    blk = hybrid_block(plan, x, y, ok, one_rank_mesh(("data", "model")),
                       use_plan=True)
    p = blk.csr
    print(f"[hybrid] train block: N_b={meta['block_size']} rows, "
          f"{p.num_edges} local edges ({p.col.numel()} slots), "
          f"H={meta['halo_width']}, host plan "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check_spmm_batch("hybrid block", p,
                     torch.rand(p.col.numel(), device="cuda"),
                     [("forward", 64), ("transpose", 64)])
    for case in gat_cases(p, ((1, 64),), ((1, 64, torch.float32,
                                           torch.float32),)):
        if case["dtype"] == "float32":
            time_case("[hybrid]", case)


def main() -> int:
    if sys.argv[1:]:
        fail(f"chip_smoke.py takes no arguments, got {sys.argv[1:]}")
    if not (REPO / "graph_hscn_tpu_torch" / "csrc").is_dir():
        fail(f"{REPO} holds no graph_hscn_tpu_torch package: run the script "
             "from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    try:
        import torch  # noqa: F401
    except ImportError:
        fail("PyTorch is not installed")
    started = time.perf_counter()
    name, count, smi = phase_device()
    build_logs = phase_build()
    kernels = (phase_kernels() + phase_fused_kernels(build_logs)
               + phase_gat_kernels() + phase_gatedgcn_kernels()
               + phase_graph_attn_kernels())
    phase_hbm()
    phase_hscn_kernels()
    phase_gin_kernels()
    phase_edge_partition_kernels()
    phase_dp_kernels()
    phase_hybrid_kernels()
    print(f"[time] chip_smoke.py: {time.perf_counter() - started:.1f} s wall "
          "from the first phase", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
