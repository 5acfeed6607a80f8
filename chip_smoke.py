#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (graph_hscn_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kink-study N   # the device and build phases,
                                           # then kink_study(N) alone

Phases; any failure exits non-zero:
  1. device  - the card's name, count, and nvidia-smi's name and power limit.
               Without a CUDA card the script stops here: no CPU fallback.
  2. build   - nvcc builds every kernel from graph_hscn_tpu_torch/csrc/, one
               process per source, all at once; prints seconds and ptxas -v.
  3. kernels - each kernel against its plain PyTorch version at its path's
               shapes, with CUDA-event times of kernel and plain version, a
               library call or yardstick, and the bound:
               - csr_spmm and edge_sddmm at a VOC-superpixels sparse GCN
                 batch (N=9784, F=64 and 21, float32 and bfloat16; the
                 transpose reads the weights in t_order in the kernel),
                 each with its launch plan, timed cold with the warm time
                 beside; then the floor of a launch under the same timer:
                 each kernel on one row or edge (the launch alone), and at
                 F=1 on the VOC plan, cold (the index chain);
               - fused_gcn_fwd/bwd at the peptides batch (G=32 graphs, slot
                 392, 9 -> 16 -> 16 -> 10, float32 and bfloat16, no dropout,
                 given bits and the seeded Philox stream), each launch
                 plan with cudaOccupancyMaxActiveClusters, timed warm and
                 cold, beside the unfused dense stack (torch.bmm) as a
                 yardstick; then at S=512, hidden 128, 5 layers, and at
                 S=1024 with input width 64 (A_hat streamed, x read from
                 global memory); the backward twice, bit for bit;
               - spmm_mh and sddmm_mh at the VOC GAT batch (N=19048, 72832
                 edge slots), every width and role of a train step:
                 spmm_mh forward and transpose (alpha read in t_order by
                 the kernel) at H*C = 64, 84 and 8, sddmm_mh at C = 16
                 (float32, bfloat16, bfloat16 with float32), 21 and 2, in
                 float32 and bfloat16, each with its launch plan, and
                 gat_edge_logits; the library call is one torch.sparse.mm /
                 sampled_addmm on the block-diagonal [H*N, H*N] CSR,
                 checked against the plain version too;
               - segment_reduce at the VOC GatedGCN batch (N=19048, 72832
                 edge slots, F=64): float32 and bfloat16, the receiver side
                 (rows in edge order) and the sender side (rows taken in
                 t_order), and a batch with empty rows; the library call is
                 torch.segment_reduce on the rows laid out beforehand,
                 checked against the plain version too;
               - [hbm] csr_spmm forward and transpose and edge_sddmm at F=128
                 on the 142 x 142 and 226 x 226 lattices (N=20164 and 51076),
                 the sizes at which the TPU takes its HBM-streamed kernels
                 (B4a-c), beside torch.sparse.mm / sampled_addmm, each
                 with its launch plan;
               - csr_spmm at the VOC sparse HSCN batch (N=5072, 19456 edge
                 slots, F=32 float32, the ll GCNConv's width): forward and
                 transpose (order), each with its launch plan, timed cold
                 with the warm time beside, its bound and torch.sparse.mm;
               - csr_spmm at the peptides GIN batch on sparse batches (the
                 first train batch with its CSR plan, the 0/1 edge mask as
                 weights): forward at F=9 (layer 0) and F=16, transpose
                 (order) at F=16, as for the HSCN batch;
               - [edge_partition] the edge-partition block (the train split
                 of configs/GCN/voc_superpixels_GCN_edge_partition.yaml on
                 one rank: N_b=201,432 rows, its local-edge CSR plan):
                 csr_spmm forward and transpose at F=64 with the block's
                 GCN weights, spmm_mh forward and transpose and sddmm_mh
                 at H=4, C=16 and 21, float32, each against its plain
                 version (1e-5*max|ref|), timed as above; segment_reduce
                 receiver and sender side at the GatedGCN config's block
                 (F=64), and csr_spmm forward and transpose at the HSCN
                 config's (F=64, the ll GCN's weights).
               Device times: CUDA events over calls queued behind a device
               sleep (at most 256 launches queued), or for a call of more
               launches the profiler's summed device time (time_ms).
               Every kernel of the sparse paths ([kernels], [gat],
               [gatedgcn], [hbm]) is timed cold, each call on the next of
               copies of its inputs that span 4x the L2 (rotating), so that
               its time compares with the HBM bound; the kernel's warm time
               (the same inputs call after call) is printed too.
  4. train   - run_experiment at full width for 2 epochs each on
               configs/GCN/voc_superpixels_GCN_sparse.yaml,
               configs/GCN/peptides_func_GCN.yaml,
               configs/GCN/peptides_func_GCN_fused.yaml,
               configs/GAT/voc_superpixels_GAT_sparse.yaml,
               configs/GAT/peptides_func_GAT.yaml,
               configs/GatedGCN/voc_superpixels_GatedGCN_sparse.yaml,
               configs/GatedGCN/peptides_struct_GatedGCN.yaml,
               configs/GCN/voc_superpixels_GCN.yaml, the
               HSCN pipeline (clustering and HSCN, 2 epochs each) on
               configs/HSCN/voc_superpixels_HSCN_sparse.yaml and the four
               shipped single-device HSCN configs, then
               configs/GIN/peptides_func_GIN.yaml (its own route, and on
               sparse batches: runtime.dense_path sparse, device_dataset
               off, the host loop with the CSR plan),
               configs/GPS/peptides_func_GPS.yaml (GCN local module),
               configs/GPS/peptides_struct_GPS.yaml (GatedGCN local module,
               cosine schedule with 100 warmup steps),
               configs/GPS/voc_superpixels_GPS.yaml (node level; graphs
               past the 512-node slot limit, so the device dataset's slot
               of 600, as the JAX runner routes it) and
               configs/GCN/peptides_struct_GCN.yaml: finite losses (the
               clustering's too), and every kernel's launch count from
               that run alone (VOC GCN: 8 csr_spmm a train step, 4 an eval
               batch; fused peptides: one fused_gcn_fwd a train step and an
               eval batch, one fused_gcn_bwd a train step; VOC GAT: 16
               spmm_mh + 12 sddmm_mh a train step, 4 + 8 an eval batch; VOC
               GatedGCN: 20 segment_reduce a train step, 8 an eval batch;
               VOC sparse HSCN: 6 csr_spmm a train step, 3 an eval batch;
               sparse GIN: 5 csr_spmm a train step (3 forwards, 2
               transposes), 3 an eval batch; the unfused device-dataset
               configs, GPS and the shipped HSCN configs: none; no launch
               while clustering).  The device-dataset configs (peptides,
               GIN, GPS, the shipped VOC GCN, the shipped HSCN) take the
               captured route: each train, eval
               and clustering step captured once as a CUDA graph and
               replayed row by row, the launch counts kept by the replay
               accounting; each then runs again eagerly row by row
               (capture=False) and a [capture] line gives both median step
               times, both max_memory_allocated, the replays, and the
               largest relative difference of their per-epoch losses (at
               most 1e-4).  An [lr] line: the peptides-struct GPS route's
               captured optimizer over a 9-epoch horizon (108 rows), the lr
               read back after every row against the schedule (within
               1e-7; shown at steps 0, 1, 99, 100 and the last).  Then a
               torch.profiler window over steady train steps of each
               sparse VOC path, the four peptides paths, the shipped VOC
               GCN, three HSCN paths, GIN on both its routes and the
               three GPS paths (device busy time, idle share, device
               operations, kernels by time; VOC GCN, GAT, HSCN and sparse
               GIN: their kernels' and the gathers' device time a step;
               GPS: the softmax, LayerNorm, matmul, elementwise and
               reduction kernels' time);
               on the device-dataset paths the replayed step beside the
               eager one, then the replays back to back under CUDA events,
               and on the fused path the fused kernels' launches seen by
               the profiler, which must equal the replay accounting; then
               each sparse VOC model, the GIN on sparse batches and the
               fused stack at full width on a 4-graph batch, on the card
               and on the CPU: logits and gradients agree; for the VOC
               sparse HSCN (virtual feedback on) its SCN's assignments
               too.
  5. resume  - checkpoints (snapshots under build/chip_smoke/): a 4-epoch
               fit uninterrupted, then cut after epoch 1's latest snapshot
               and resumed by a fresh model, optimizer and Checkpointer,
               on configs/GCN/peptides_func_GCN.yaml (captured, dropout
               0.2), the sparse VOC GCN (host loop, its csr_spmm launches
               counted) and configs/GPS/peptides_struct_GPS.yaml (cosine,
               100 warmup steps; the lr read back after every row against
               the schedule, within 1e-7): epochs 2-3's train losses
               within 1e-6 relative of the uninterrupted run's.
     eval    - run_eval(cfg, "best") on the fused twin and the sparse VOC
               GCN after a fit with checkpoint_dir: the val loss equal to
               the fit's best (rtol 1e-5, atol 1e-6), the fused_gcn_fwd
               and csr_spmm launches counted; `python -m
               graph_hscn_tpu_torch.main --eval best --predict out.npz` in
               a subprocess (the four arrays, the real row counts); and the
               HSCN clusters of the host and device routes on
               configs/HSCN/peptides_func_HSCN.yaml, compared (printed).
     pe      - configs/GCN/peptides_func_GCN_PE.yaml as shipped (the
               frozen SignNet transform; its wall time and the width it
               leaves, 9) and with compat.frozen_random_signnet false
               (EncodedModel in the captured graphs), each captured and
               eager (capture_run); the EncodedModel on a 4-graph batch,
               card against CPU (1e-4*max|ref|), and batched_eigh on the
               card against the host stats, in float64 (eigenvalues 1e-5,
               projectors 1e-4) and float32 (reported).
     edge_partition - configs/GCN/voc_superpixels_GCN_edge_partition.yaml
               and configs/GAT/voc_superpixels_GAT_edge_partition.yaml
               with mesh.shape [1] (they ask for 8 devices; every other key
               as shipped, 512 graphs, hidden 64, 4 layers), and GIN by the
               GCN config's conv_type: run_experiment 2 epochs each on a
               1-rank NCCL group made by the runner (N_b, E, H and the host
               plan's seconds of each split; step ms; launches: GCN 6
               csr_spmm a train step and 3 an eval forward, GAT 8 spmm_mh
               + 4 sddmm_mh and 4, GIN none); a train step profiled (idle
               share, the kernels' and NCCL's device time); the model on
               the val split, card against CPU (logits 1e-5*max|ref|, loss
               and gradients 1e-4*max|ref|, the CPU's gradient pass on the
               card's ReLU and leaky-ReLU decisions: KinkPins; at most
               1e-5 of them may differ); [resume] and [eval] of the GCN
               one, and its predict export in a subprocess.  Likewise
               configs/GatedGCN/voc_superpixels_GatedGCN_edge_partition.yaml
               at mesh.shape [1] (20 segment_reduce a train step, 8 an
               eval forward), configs/GPS/voc_superpixels_GPS.yaml with
               mesh.edge_partition on at 64 graphs (ring attention is
               O(N_b^2); no kernel) and
               configs/HSCN/voc_superpixels_HSCN_edge_partition.yaml as
               shipped (shape [-1], 5 clustering epochs: 6 csr_spmm a train
               step, 3 an eval forward, none while clustering; the card
               against the CPU with the card's clusters, and the SCN's
               losses), with [resume] and [eval] of the HSCN one.
     dp      - configs/GCN/peptides_func_GCN_dp8.yaml's widths (global
               batch 128, hidden 128, 5 layers, slot 392) through fit_dp on
               a 1-rank NCCL group (run_experiment's data_parallel), 2
               epochs without dropout: per-epoch losses within 1e-5
               relative of the single-device host fit on the same global
               batches; its runtime.fused_stack: on twin (fused_gcn_fwd /
               fused_gcn_bwd launches counted) and its runtime.dense_path:
               sparse twin (csr_spmm: 10 a train step, 5 an eval batch);
               each run's step ms and peak memory, a train step profiled
               (idle share); csr_spmm at the sparse twin's first batch
               (F = 128 and 10, forward and transpose) and the fused
               kernels at G = 128, S = 392 against their plain versions.
     hybrid  - configs/GCN/voc_superpixels_GCN_hybrid.yaml at mesh.shape
               [1, 1] (512 graphs, hidden 64, 4 layers): csr_spmm (F = 64,
               forward and transpose) and spmm_mh / sddmm_mh (one head,
               C = 64) at the train block against their plain versions;
               run_experiment 2 epochs with a checkpoint_dir (6 csr_spmm a
               train step, 3 an eval forward), run_eval and main --eval
               --predict on its snapshot; its GAT twin (JAX's one head: 6
               spmm_mh + 3 sddmm_mh a train step, 3 spmm_mh an eval
               forward) and GPS twin (64 graphs, no kernel); GCN and GAT on
               the val block, card against CPU (KinkPins, float32 pinned).
     loader  - configs/GCN/voc_superpixels_GCN_sparse.yaml with
               data.num_workers 2: two epochs' train batches equal, array
               for array with their CSR plans, to the JAX PrefetchLoader's
               order (shuffle by default_rng(seed), batch_size chunks, a
               chunk over the budget split in halves); run_experiment 2
               epochs (csr_spmm counted), its median step ms beside the
               num_workers 0 run's; an epoch of each profiled (idle share).
A [time] line gives the script's wall time.  The last three lines are the
{"kernels": [...]} record, nvidia-smi's line, and {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "GCN" / "voc_superpixels_GCN_sparse.yaml"
VOC_GCN = REPO / "configs" / "GCN" / "voc_superpixels_GCN.yaml"
PEPTIDES = REPO / "configs" / "GCN" / "peptides_func_GCN.yaml"
PEPTIDES_FUSED = REPO / "configs" / "GCN" / "peptides_func_GCN_fused.yaml"
VOC_GAT = REPO / "configs" / "GAT" / "voc_superpixels_GAT_sparse.yaml"
PEPTIDES_GAT = REPO / "configs" / "GAT" / "peptides_func_GAT.yaml"
VOC_GATED = (REPO / "configs" / "GatedGCN"
             / "voc_superpixels_GatedGCN_sparse.yaml")
PEPTIDES_GATED = (REPO / "configs" / "GatedGCN"
                  / "peptides_struct_GatedGCN.yaml")
VOC_HSCN = REPO / "configs" / "HSCN" / "voc_superpixels_HSCN_sparse.yaml"
PEPTIDES_HSCN = REPO / "configs" / "HSCN" / "peptides_func_HSCN.yaml"
SHIPPED_HSCN = [REPO / "configs" / "HSCN" / f"{name}.yaml" for name in (
    "peptides_func_HSCN", "peptides_func_HSCN_parity",
    "peptides_func_HSCN_feedback", "voc_superpixels_HSCN")]
GIN = REPO / "configs" / "GIN" / "peptides_func_GIN.yaml"
# The GIN config on sparse batches: the host loop with the CSR plan, each
# GINConv's aggregation through csr_spmm.
GIN_SPARSE = {"runtime.dense_path": "sparse", "runtime.device_dataset": "off"}
GPS_FUNC = REPO / "configs" / "GPS" / "peptides_func_GPS.yaml"
GPS_STRUCT = REPO / "configs" / "GPS" / "peptides_struct_GPS.yaml"
GPS_VOC = REPO / "configs" / "GPS" / "voc_superpixels_GPS.yaml"
PEPTIDES_STRUCT_GCN = REPO / "configs" / "GCN" / "peptides_struct_GCN.yaml"
PEPTIDES_PE = REPO / "configs" / "GCN" / "peptides_func_GCN_PE.yaml"
TRAINABLE_PE = {"compat.frozen_random_signnet": False}
# The edge-partition configs ask for an 8-device mesh; one card runs them
# on a 1-rank mesh (JAX honours edge_partition there too), every other key
# as shipped; GIN by the GCN config's conv_type.
GCN_EP = REPO / "configs" / "GCN" / "voc_superpixels_GCN_edge_partition.yaml"
GAT_EP = REPO / "configs" / "GAT" / "voc_superpixels_GAT_edge_partition.yaml"
GATED_EP = (REPO / "configs" / "GatedGCN"
            / "voc_superpixels_GatedGCN_edge_partition.yaml")
HSCN_EP = REPO / "configs" / "HSCN" / "voc_superpixels_HSCN_edge_partition.yaml"
DP8 = REPO / "configs" / "GCN" / "peptides_func_GCN_dp8.yaml"
HYBRID = REPO / "configs" / "GCN" / "voc_superpixels_GCN_hybrid.yaml"
# fit_dp on one rank, without dropout (the single-device fit it is held
# against draws other bits); its fused and sparse twins.
DP_ONE = {"mesh.shape": [1], "mpnn.dropout": 0.0}
DP_FUSED = {**DP_ONE, "runtime.fused_stack": "on"}
DP_SPARSE = {**DP_ONE, "runtime.dense_path": "sparse"}
HYBRID_ONE = {"mesh.shape": [1, 1]}
HYBRID_GAT = {**HYBRID_ONE, "mpnn.conv_type": "gat"}
# Ring attention is O(N_b^2): 64 graphs, as the [edge_partition] GPS.
HYBRID_GPS = {**HYBRID_ONE, "mpnn.conv_type": "gps", "mpnn.num_heads": 4,
              "data.num_graphs": 64}
ONE_RANK = {"mesh.shape": [1]}
GIN_EP = {"mesh.shape": [1], "mpnn.conv_type": "gin"}
# The VOC GPS config on the edge-partitioned route: ring attention costs
# O(N_b^2), so 64 graphs (N_b ~ 25k) instead of 512; the widths as shipped.
GPS_EP = {"mesh.shape": [1], "mesh.edge_partition": True,
          "data.num_graphs": 64}
VOC_CLASSES = 21
# Checkpoints and the predict export of [resume] and [eval]: inside the
# checkout, in a directory git ignores.
SCRATCH = REPO / "build" / "chip_smoke"
HBM_SIDES = (142, 226)   # lattices of N = 20164 and 51076 (B4a, B4b sizes)
EPOCHS = 2
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


def profiled(fn, calls: int) -> tuple[list, float]:
    """(device operations, host wall ms) of ``calls`` calls of ``fn`` under
    torch.profiler: kernels, copies and fills, not user annotations (the
    optimizer's record_function range spans kernels already counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    return dev, wall_ms


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
    dev, _ = profiled(fn, calls)
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
    under the same timer.  Returns the kernels' records (without launch
    counts): F=64 float32, forward and dw, cold."""
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
    return {"launches": 0, "max_abs_err": worst_err, "ms": case["ms"],
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
    assumes), the kernel warm beside it.  Returns the two kernels' records
    (without launch counts): H=4 C=16 float32, forward and dots, cold."""
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
    call are timed cold (``rotating``).  Returns the kernel's record
    (without its launch count)."""
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


def phase_hbm():
    """csr_spmm (forward and transpose) and edge_sddmm at F = 128 on the
    square 4-neighbour lattices at which the TPU routes the SpMM to its
    HBM-streamed kernels (B4a at N = 20164, B4b at N = 51076; B4c is their
    dw, edge_sddmm's function), against their plain versions and beside
    torch.sparse.mm / sampled_addmm, all timed cold; the transpose reads
    the weights in t_order in the kernel.  Same tolerances as phase 3."""
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


def all_kernels():
    """Every kernel wrapper of the port, each with its launch counter."""
    from graph_hscn_tpu_torch.ops.cuda.multihead_kernel import (sddmm_mh,
                                                                spmm_mh)
    from graph_hscn_tpu_torch.ops.cuda.sddmm_kernel import edge_sddmm
    from graph_hscn_tpu_torch.ops.cuda.segment_reduce_kernel import (
        segment_reduce)
    from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import csr_spmm
    from graph_hscn_tpu_torch.ops.fused_gcn import (fused_gcn_bwd,
                                                    fused_gcn_fwd)
    return (csr_spmm, edge_sddmm, fused_gcn_fwd, fused_gcn_bwd, spmm_mh,
            sddmm_mh, segment_reduce)


def load_with(path: Path, changes: dict | None = None):
    """The config at ``path`` with ``changes`` ({"section.field": value})
    set."""
    from graph_hscn_tpu_torch.config.config import load_config
    cfg = load_config(path)
    for key, value in (changes or {}).items():
        section, field = key.split(".")
        setattr(getattr(cfg, section), field, value)
    return cfg


def train_run(path: Path, expected, label: str = "train",
              changes: dict | None = None,
              cluster_epochs: int | None = EPOCHS, run=None) -> tuple:
    """One path through run_experiment on the card for EPOCHS epochs, every
    kernel's launch count from that run alone.  ``expected(cfg, steps,
    evals)`` gives the counts the path must show (a kernel it leaves out:
    0); ``changes`` are set on the config (``load_with``); an HSCN's
    clustering runs ``cluster_epochs`` epochs (None: as shipped); ``run``
    (default run_experiment) is the entry point, ``run(cfg,
    step_timing=True)``.  Returns
    ({kernel: launches}, the FitResult, the median step ms,
    max_memory_allocated above what was allocated at the start)."""
    import torch

    from graph_hscn_tpu_torch.runner import run_experiment

    cfg = load_with(path, changes)
    cfg.training.epochs = EPOCHS
    cfg.training.eval_period = 1
    if cfg.hscn is not None and cluster_epochs is not None:
        cfg.hscn.cluster_epochs = cluster_epochs
    # What earlier runs left allocated (their garbage collected): the
    # baseline of this run's peak.
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    clustering: dict = {}
    t0 = time.perf_counter()
    with launches_while_clustering(kernels, clustering):
        result = (run or run_experiment)(cfg, step_timing=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    tag = f"[{label}] {path.name}" + (f" {changes}" if changes else "")
    if cfg.hscn is not None:
        cl = result.cluster_losses
        print(f"{tag}: clustering {len(cl)} epochs, losses "
              f"{cl}; launches while clustering {clustering}", flush=True)
        if (len(cl) != cfg.hscn.cluster_epochs
                or not all(math.isfinite(v) for v in cl)):
            fail(f"{path.name}: clustering losses {cl}")
        if not clustering or any(clustering.values()):
            fail(f"{path.name}: kernel launches while clustering: "
                 f"{clustering} (the clustering batches carry no plan)")
    steps, evals = result.num_train_steps, result.num_eval_batches
    want = dict.fromkeys(launches, 0)
    want.update(expected(cfg, steps, evals))
    print(f"{tag}: {type(result.model).__name__}, "
          f"{result.epochs_run} epochs, {steps} train steps, {evals} eval "
          f"batches in {wall:.2f} s; launches {launches} (expected {want}); "
          f"replays {result.replays}", flush=True)
    losses = [v for h in result.history for k, v in h.items()
              if k.endswith("_loss")]
    if not losses or not all(math.isfinite(v) for v in losses):
        fail(f"{path.name}: non-finite or missing losses: {losses}")
    if launches != want:
        fail(f"{path.name}: launches {launches}, want {want}")
    ms = [s * 1e3 for s in result.step_seconds]
    median = statistics.median(ms)
    memory = torch.cuda.max_memory_allocated() - held
    print(f"{tag} step ms (synchronised host clock): median "
          f"{median:.3f}, first {ms[0]:.3f}, min "
          f"{min(ms):.3f}, max {max(ms):.3f}; max_memory_allocated "
          f"{memory} bytes above the {held} held at the start", flush=True)
    for h in result.history:
        print(f"{tag} {h}")
    return launches, result, median, memory


@contextlib.contextmanager
def eager_route():
    """Within the block the device-resident route runs its steps eagerly
    row by row (``capture=False``), the yardstick beside the captured
    steps: fit_on_device_dataset where fit_device and the HSCN pipeline
    look it up, and the pipeline's train_clustering_device."""
    import functools

    from graph_hscn_tpu_torch import hscn_pipeline
    from graph_hscn_tpu_torch.train import loop
    names = [(loop, "fit_on_device_dataset"),
             (hscn_pipeline, "fit_on_device_dataset"),
             (hscn_pipeline, "train_clustering_device")]
    saved = [getattr(m, n) for m, n in names]
    for (m, n), fn in zip(names, saved):
        setattr(m, n, functools.partial(fn, capture=False))
    try:
        yield
    finally:
        for (m, n), fn in zip(names, saved):
            setattr(m, n, fn)


def capture_run(path: Path, expected, changes: dict | None = None) -> dict:
    """A device-resident path twice: captured (the main path, whose
    launches are returned) and eager (``capture=False``), in turn.  Prints
    the [capture] line: both median step times, the largest relative
    difference of their per-epoch train, val and test losses (at most
    1e-4), both max_memory_allocated, and the captured run's replays; the
    launch counts must be the expected ones in both."""
    launches, got, ms, mem = train_run(path, expected, "train", changes)
    with eager_route():
        _, ref, ms_eager, mem_eager = train_run(path, expected, "eager",
                                                changes)
    if not got.replays or got.replays["train"] != got.num_train_steps - 1:
        fail(f"{path.name}: captured run replays {got.replays} for "
             f"{got.num_train_steps} train steps")
    if any(ref.replays.values()):
        fail(f"{path.name}: the eager run replayed {ref.replays}")
    worst = 0.0
    for h, e in zip(got.history, ref.history):
        for key in ("train_loss", "validation_loss", "test_loss"):
            worst = max(worst, abs(h[key] - e[key]) / max(abs(e[key]),
                                                          1e-30))
    cl = [abs(a - b) for a, b in zip(got.cluster_losses, ref.cluster_losses)]
    print(f"[capture] {path.name}: median step ms captured {ms:.3f}, eager "
          f"{ms_eager:.3f} ({ms_eager / ms:.2f}x); losses max relative "
          f"difference {worst:.3e} (limit 1e-4)"
          + (f", clustering losses max |difference| {max(cl):.3e}"
             if cl else "")
          + f"; max_memory_allocated captured {mem}, eager {mem_eager} "
          f"bytes; replays {got.replays}", flush=True)
    if len(got.history) != len(ref.history) or not worst <= 1e-4:
        fail(f"{path.name}: captured and eager losses differ by {worst:.3e}"
             " relative (limit 1e-4)")
    return launches


@contextlib.contextmanager
def launches_while_clustering(kernels, into: dict):
    """Within the block, the HSCN pipeline's clustering trainers (and the
    edge-partitioned pipeline's SCN steps) add each kernel's launches
    during their run to ``into``."""
    from graph_hscn_tpu_torch import hscn_pipeline
    from graph_hscn_tpu_torch.parallel import sharded_scn
    names = ((hscn_pipeline, "train_clustering"),
             (hscn_pipeline, "train_clustering_device"),
             (sharded_scn, "scn_loss_and_grads"))
    originals = {(m, n): getattr(m, n) for m, n in names}

    def counted(fn):
        def run(*args, **kwargs):
            before = {k.__name__: k.launches for k in kernels}
            out = fn(*args, **kwargs)
            for k in kernels:
                into[k.__name__] = (into.get(k.__name__, 0) + k.launches
                                    - before[k.__name__])
            return out
        return run

    for (m, n), fn in originals.items():
        setattr(m, n, counted(fn))
    try:
        yield
    finally:
        for (m, n), fn in originals.items():
            setattr(m, n, fn)


def voc_hscn_launches(cfg, steps, evals):
    """The sparse HSCN: csr_spmm forward and dx in each layer's ll GCNConv
    in a train step, forward in an eval batch (the lv and vv relations take
    plain ops; clustering, run before, launches nothing)."""
    layers = cfg.hscn.num_layers
    return {"csr_spmm": 2 * layers * steps + layers * evals}


def voc_gcn_launches(cfg, steps, evals):
    """The sparse GCN: csr_spmm forward and dx a layer in a train step,
    forward in an eval batch; edge_sddmm never (the GCN weights carry no
    gradient)."""
    layers = cfg.mpnn.num_layers
    return {"csr_spmm": 2 * layers * steps + layers * evals}


def voc_gat_launches(cfg, steps, evals):
    """The sparse GAT with self loops, a layer: forward 2 sddmm_mh
    (gat_edge_logits for the logits and for the max shift) and 1 spmm_mh;
    backward 1 spmm_mh + 1 sddmm_mh (spmm_mh's dx and d alpha) and 2
    spmm_mh (the logits' two operands; the max shift is detached)."""
    layers = cfg.mpnn.num_layers
    return {"spmm_mh": 4 * layers * steps + layers * evals,
            "sddmm_mh": 3 * layers * steps + 2 * layers * evals}


def voc_gatedgcn_launches(cfg, steps, evals):
    """The sparse GatedGCN, a layer: forward 2 segment_reduce (the two
    segment sums); backward 3 (the three edge gathers; the segment sums'
    backward is a plain gather)."""
    layers = cfg.mpnn.num_layers
    return {"segment_reduce": 5 * layers * steps + 2 * layers * evals}


def gin_sparse_launches(cfg, steps, evals):
    """The GIN MPNN on sparse batches: csr_spmm forward in each GINConv,
    and its transpose for dx in every layer but the first (whose input,
    the node features, takes no gradient), in a train step; forward in an
    eval batch; edge_sddmm never (the mask weights carry no gradient)."""
    layers = cfg.mpnn.num_layers
    return {"csr_spmm": (2 * layers - 1) * steps + layers * evals}


def fused_launches(cfg, steps, evals):
    return {"fused_gcn_fwd": steps + evals, "fused_gcn_bwd": steps}


def no_launches(cfg, steps, evals):
    return {}


def profile_steps(label: str, step, make_batch, steps: int = 6,
                  focus: dict | None = None) -> None:
    """Where a train step's time goes: ``step(make_batch(i))`` over
    ``steps`` steady steps (after 3 warm-up steps) under torch.profiler;
    device busy time, idle share, and the kernels by device time (see
    :func:`report_profile`)."""
    import torch

    for i in range(3):   # warm-up
        step(make_batch(i))
    torch.cuda.synchronize()
    it = iter(range(steps))
    dev, wall_ms = profiled(lambda: step(make_batch(next(it))), steps)
    report_profile(label, dev, wall_ms, steps, "train steps", focus)


def report_profile(label: str, dev: list, wall_ms: float, steps: int,
                   what: str, focus: dict | None = None) -> None:
    """Prints a profiled window of ``steps`` steps: device busy time, idle
    share, device operations and the kernels by device time a step.
    ``focus``: {label: name substrings}, each group's summed device time
    and count a step (a device operation whose name holds a substring)."""
    if not dev:
        print(f"[profile] {label}: the profiler recorded no device events: "
              "device busy time not measured", flush=True)
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    print(f"[profile] {label}: {steps} {what} (profiler on): wall "
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
    for group, keys in (focus or {}).items():
        ts = [t for name, times in by_name.items()
              if any(k in name for k in keys) for t in times]
        print(f"[profile] {label}, {group}: {sum(ts) / steps:.2f} us a step "
              f"of device time, {len(ts) / steps:.1f} operations a step",
              flush=True)


# The device launches of the fused stack's kernels, by the names the
# profiler gives them: the forward, the backward and its partial sums.
FUSED_KERNEL_NAMES = {"fused_gcn_fwd": "fused_gcn_fwd_kernel",
                      "fused_gcn_bwd": "fused_gcn_bwd_kernel",
                      "sum_partials": "sum_partials_kernel"}


def profile_replays(label: str, train_epoch, perm, steps: int = 6,
                    focus: dict | None = None) -> None:
    """The captured train step (a ``device_data.RowSteps`` made by
    make_epoch_fn) replayed under the profiler: one epoch over ``perm``
    first (the eager first row, the capture, the replays), then the first
    ``steps`` rows of it again, all replays; reported as
    :func:`report_profile` reports.  The
    fused stack's kernels, counted on the device over the profiled
    replays, must equal the wrappers' replay accounting (0 where the path
    has none), and every fused_gcn_bwd launch brings its partial sums."""
    import torch

    train_epoch(perm)
    if train_epoch.load(perm) < steps:
        fail(f"{label}: {len(perm)} rows, too few to profile {steps} "
             "replays")
    torch.cuda.synchronize()
    kernels = all_kernels()
    before = {k.__name__: k.launches for k in kernels}
    replays = train_epoch.replays
    dev, wall_ms = profiled(train_epoch.step, steps)
    if train_epoch.replays - replays != steps:
        fail(f"{label}: {train_epoch.replays - replays} replays profiled, "
             f"want {steps}")
    counted = {k.__name__: k.launches - before[k.__name__] for k in kernels}
    report_profile(label, dev, wall_ms, steps, "replayed train steps", focus)
    # The replays back to back, no sync between them and no profiler (whose
    # tracing of a graph's nodes slows its launch): CUDA events around the
    # epoch's rows.
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / steps
    nb = train_epoch.load(perm)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(nb):
        train_epoch.step()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / nb
    print(f"[profile] {label}: {nb} replayed train steps back to back (CUDA "
          f"events, no profiler): {ms:.3f} ms a step, idle share "
          f"{1 - busy_ms / ms:.3f} against the profiled busy time",
          flush=True)
    seen = {k: sum(n in e.name for e in dev)
            for k, n in FUSED_KERNEL_NAMES.items()}
    print(f"[profile] {label}, replays: kernel launches counted by the "
          f"wrappers {counted}; fused kernels seen by the profiler {seen}",
          flush=True)
    if (seen["fused_gcn_fwd"] != counted["fused_gcn_fwd"]
            or seen["fused_gcn_bwd"] != counted["fused_gcn_bwd"]
            or seen["sum_partials"] != seen["fused_gcn_bwd"]):
        fail(f"{label}: the profiler saw {seen} fused kernel launches over "
             f"{steps} replays, the replay accounting {counted}")


# The VOC GCN step's aggregation: the kernel, and the gathers around it.
GCN_FOCUS = {"csr_spmm kernel": ("csr_spmm_kernel",),
             "gathers (index_select, indexing)": ("indexSelect", "gather")}
# The VOC GAT step's attention work: the two kernels, and the gathers left
# around them (index_select and indexing kernels).
GAT_FOCUS = {"spmm_mh + sddmm_mh kernels": ("spmm_mh_kernel",
                                            "sddmm_mh_kernel"),
             "gathers (index_select, indexing)": ("indexSelect", "gather")}
GATED_FOCUS = {"segment_reduce kernel": ("segment_reduce_kernel",),
               "gathers and scatters (index_select, index_add_)": (
                   "indexSelect", "gather", "index_add", "indexFuncLarge")}


def phase_profile(path: Path, label: str, focus: dict | None = None,
                  changes: dict | None = None):
    """A sparse host-loop path's fit-loop body (move the batch, train
    step): a VOC sparse config, or a config on sparse batches by
    ``changes`` (``load_with``)."""
    import torch

    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.models.mpnn import build_mpnn
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    from graph_hscn_tpu_torch.train.loop import make_train_step
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer

    cfg = load_with(path, changes)
    set_matmul_precision(cfg.runtime.matmul_precision)
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    dm.with_spmm_plan = True
    batches = list(dm.train_batches(epoch_seed=dm.seed))
    node_level = dm.task_level == "node"
    model = build_mpnn(cfg.mpnn, dm.num_features, dm.num_classes,
                       compat=cfg.compat.double_relu,
                       readout="none" if node_level else "mean",
                       generator=torch.Generator().manual_seed(0),
                       num_edge_features=dm.num_edge_features).cuda()
    opt = build_optimizer(model.parameters(), cfg.optim.optim_type,
                          cfg.optim.lr, cfg.optim.weight_decay)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step, _ = make_train_step(model, opt, cfg.training.loss_fn,
                              node_level=node_level, generator=gen)
    profile_steps(label, step, lambda i: batches[i % len(batches)].to("cuda"),
                  focus=focus)


def phase_reference(path: Path, changes: dict | None = None):
    """A sparse-batch config's full-width model (``changes`` set on the
    config) on a 4-graph batch with its CSR plan: the card (kernels)
    against the CPU (plain versions), logits and every parameter
    gradient."""
    import torch

    from graph_hscn_tpu_torch.data.batching import PadBudget, pack_batch
    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.models.mpnn import build_mpnn
    from graph_hscn_tpu_torch.ops import spmm
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    from graph_hscn_tpu_torch.train.loss import criterion

    cfg = load_with(path, changes)
    set_matmul_precision(cfg.runtime.matmul_precision)
    dm = DataModule.from_config(cfg.data)
    node_level = dm.task_level == "node"
    graphs = dm.split("val")[:4]
    batch = pack_batch(graphs, PadBudget.for_dataset(graphs, 4),
                       with_spmm_plan=True)
    model = build_mpnn(cfg.mpnn, dm.num_features, dm.num_classes,
                       readout="none" if node_level else "mean",
                       generator=torch.Generator().manual_seed(1),
                       num_edge_features=dm.num_edge_features)
    model.eval()
    outs = {}
    prev = spmm.get_backend()
    spmm.set_backend("pallas")    # the kernel path, plain versions on CPU
    try:
        for dev, m in (("cpu", model), ("cuda", copy.deepcopy(model))):
            m = m.to(dev)
            b = batch.to(dev)
            logits = m(b)
            true, mask = ((b.node_y, b.node_mask) if node_level
                          else (b.y, b.graph_mask))
            loss, _ = criterion(cfg.training.loss_fn, logits, true, mask)
            params = list(m.parameters())
            # A parameter the loss does not reach (the last GatedGCN
            # layer's edge LayerNorm) has a zero gradient.
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            outs[dev] = [logits.detach()] + [
                torch.zeros_like(q) if g is None else g
                for q, g in zip(params, grads)]
    finally:
        spmm.set_backend(prev)
    worst = 0.0
    for ref, got in zip(outs["cpu"], outs["cuda"]):
        err = float((got.cpu() - ref).abs().max())
        tol = 1e-4 * max(float(ref.abs().max()), 1e-3)
        if not got.isfinite().all() or err > tol:
            fail(f"{path.name} {changes or ''} card vs CPU: max |err| "
                 f"{err:.3e} > {tol:.3e}")
        worst = max(worst, err / max(float(ref.abs().max()), 1e-3))
    print(f"[reference] {path.name}{f' {changes}' if changes else ''}, "
          "4-graph batch "
          f"(N={batch.num_nodes_padded}): logits "
          f"and {len(outs['cpu']) - 1} gradients agree with the CPU, worst "
          f"relative error {worst:.2e}", flush=True)


def peptides_setup(path: Path, fused: bool, slotted: bool = True):
    """(cfg, dm, ds, model) at a device-dataset config's full width: the
    data (with dense slots, or ``slotted`` False: the slot the dataset
    picks, as the runner leaves it for graphs over 512 nodes), the
    device-resident dataset of all its graphs on the card, and the model
    the runner builds for it (weights from seed 0)."""
    import torch

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.models.fused_gcn import FusedDenseGCN
    from graph_hscn_tpu_torch.models.mpnn import build_mpnn
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    from graph_hscn_tpu_torch.train.device_data import DeviceDataset

    cfg = load_config(path)
    set_matmul_precision(cfg.runtime.matmul_precision)
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    if slotted and not dm.enable_dense_slots():
        fail(f"{path.name}: the graphs do not fit dense slots")
    ds = DeviceDataset.build(dm.graphs, slot=dm.slot_nodes, device="cuda")
    gen = torch.Generator().manual_seed(0)
    readout = "none" if dm.task_level == "node" else "mean"
    if fused:
        model = FusedDenseGCN(dm.num_features, cfg.mpnn.hidden_channels,
                              dm.num_classes, cfg.mpnn.num_layers,
                              dropout=cfg.mpnn.dropout, generator=gen)
    else:
        model = build_mpnn(cfg.mpnn, dm.num_features, dm.num_classes,
                           compat=cfg.compat.double_relu, readout=readout,
                           generator=gen,
                           num_edge_features=dm.num_edge_features)
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
    (:func:`phase_fused_wide`).  Returns their records (without launch
    counts)."""
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
    cfg, dm, ds, model = peptides_setup(PEPTIDES_FUSED, fused=True)
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


def train_rows(dm, batch_size: int, seed: int = 0) -> np.ndarray:
    """The train split's rows of one epoch, as fit_on_device_dataset lays
    them out (dataset ids, -1 for dummy slots)."""
    from graph_hscn_tpu_torch.train.device_data import epoch_permutation
    ids = dm.split_idx["train"]
    perm = epoch_permutation(len(ids), batch_size, seed)
    return np.where(perm >= 0, ids[np.clip(perm, 0, None)], -1).astype(
        np.int32)


def route_optimizer(params, cfg, n_train: int):
    """The optimizer fit_on_device_dataset builds for ``cfg`` on the card:
    capturable, with the config's schedule over its horizon (epochs x the
    rows an epoch of ``n_train`` graphs) and its accumulation."""
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer
    o = cfg.optim
    return build_optimizer(
        params, o.optim_type, o.lr, o.weight_decay, o.batch_accumulation,
        o.clip_grad_norm, schedule=o.schedule, warmup_steps=o.warmup_steps,
        total_steps=cfg.training.epochs * -(-n_train // cfg.data.batch_size),
        capturable=True)


# The GPS step's stock-op groups: the attention's softmax, every LayerNorm,
# every matmul (cuBLAS and CUTLASS gemms: the attention's batched ones and
# the Dense layers'), every kernel of PyTorch's elementwise_kernel
# templates (pointwise ops: the mask bias, the scaling, activations, the
# optimizer's; and the index gathers built on them) and every reduction
# (its reduce_kernel template).
GPS_FOCUS = {"softmax (forward, backward)": ("softmax",),
             "LayerNorm (forward, backward)": ("layer_norm", "GammaBeta"),
             "gemm (all matmuls)": ("gemm",),
             "elementwise (pointwise and index kernels)":
                 ("elementwise_kernel",),
             "reductions": ("reduce_kernel",)}


def phase_profile_peptides(path: Path, label: str, fused: bool = False,
                           slotted: bool = True, focus: dict | None = None):
    """A device-dataset train step under the profiler, eager (assemble the
    batch on the card, train step) and then replayed (the step captured by
    make_epoch_fn, on a copy of the same model); the optimizer as the
    device route builds it (``route_optimizer``)."""
    import torch

    from graph_hscn_tpu_torch.train.device_data import (assemble,
                                                        make_epoch_fn)
    from graph_hscn_tpu_torch.train.loop import make_train_step

    cfg, dm, ds, model = peptides_setup(path, fused, slotted)
    node_level = dm.task_level == "node"
    n_train = len(dm.split_idx["train"])
    captured = copy.deepcopy(model)
    opt = route_optimizer(model.parameters(), cfg, n_train)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step, _ = make_train_step(model, opt, cfg.training.loss_fn,
                              node_level=node_level, generator=gen)
    perm = train_rows(dm, cfg.data.batch_size)
    rows = torch.as_tensor(perm, device="cuda")
    profile_steps(label, step, lambda i: assemble(ds, rows[i % len(rows)]),
                  focus=focus)
    opt = route_optimizer(captured.parameters(), cfg, n_train)
    gen = torch.Generator(device="cuda").manual_seed(0)
    train_epoch, _ = make_epoch_fn(captured, opt, ds, cfg.data.batch_size,
                                   len(perm), cfg.training.loss_fn,
                                   node_level=node_level, generator=gen)
    profile_replays(label, train_epoch, perm, focus=focus)


LR_STEPS = (0, 1, 99, 100)


def phase_lr_schedule(path: Path, epochs: int = 9):
    """The lr the captured optimizer uses on a config's device route: the
    model and optimizer as the route builds them, the horizon of an
    ``epochs``-epoch fit (108 rows for peptides-struct GPS: its 100 warmup
    steps and a decay to the end); each row a replay but the first,
    the lr read back after it.  Every row's lr must be the schedule's at
    the count of updates already applied, within 1e-7; printed at
    LR_STEPS and the last row."""
    import torch

    from graph_hscn_tpu_torch.train.device_data import make_epoch_fn
    from graph_hscn_tpu_torch.train.optimizers import learning_rate_schedule

    cfg, dm, ds, model = peptides_setup(path, fused=False)
    cfg.training.epochs = epochs
    o, B = cfg.optim, cfg.data.batch_size
    n_train = len(dm.split_idx["train"])
    horizon = epochs * -(-n_train // B)
    opt = route_optimizer(model.parameters(), cfg, n_train)
    sched = learning_rate_schedule(o.lr, o.schedule, o.warmup_steps, horizon)
    train_epoch, _ = make_epoch_fn(
        model, opt, ds, B, -(-n_train // B), cfg.training.loss_fn,
        node_level=dm.task_level == "node",
        generator=torch.Generator(device="cuda").manual_seed(0))
    used = []
    for epoch in range(epochs):
        nb = train_epoch.load(train_rows(dm, B, cfg.training.seed + epoch))
        for _ in range(nb):
            train_epoch.step()
            used.append(float(opt.opt.param_groups[0]["lr"]))
    want = sched(torch.arange(len(used), dtype=torch.float32)).tolist()
    worst = max(abs(a - b) for a, b in zip(used, want))
    shown = ", ".join(f"step {i}: {used[i]:.9g} (schedule {want[i]:.9g})"
                      for i in (*LR_STEPS, len(used) - 1))
    print(f"[lr] {path.name}: {o.optim_type} {o.schedule}, warmup "
          f"{o.warmup_steps}, horizon {horizon} updates, {len(used)} train "
          f"rows ({train_epoch.replays} replays): {shown}; max |lr - "
          f"schedule| over every row {worst:.3e} (limit 1e-7)", flush=True)
    if len(used) <= max(LR_STEPS) or train_epoch.replays != len(used) - 1:
        fail(f"{path.name}: {len(used)} rows, {train_epoch.replays} "
             "replays")
    if not worst <= 1e-7:
        fail(f"{path.name}: the captured lr is {worst:.3e} from the "
             "schedule")


def phase_profile_hscn(path: Path, label: str, focus: dict | None = None):
    """An HSCN train step under the profiler, on its config's route: the
    VOC sparse twin's host batches (moved to the card, the CSR plan
    attached), or a peptides config's device dataset (the batch assembled
    on the card; then, replayed, the step captured by make_epoch_fn on a
    copy of the same model).  Cluster ids come from a seeded draw
    (``hscn_data``), not a clustering run."""
    import torch

    from graph_hscn_tpu_torch.models.hscn import build_hscn
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    from graph_hscn_tpu_torch.train.device_data import (DeviceDataset,
                                                        assemble,
                                                        epoch_permutation,
                                                        make_epoch_fn)
    from graph_hscn_tpu_torch.train.loop import make_train_step
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer

    cfg, dm = hscn_data(path)
    set_matmul_precision(cfg.runtime.matmul_precision)
    node_level = dm.task_level == "node"
    model = build_hscn(cfg.hscn, dm.num_features, dm.num_classes,
                       readout="none" if node_level else "mean",
                       generator=torch.Generator().manual_seed(0)).cuda()
    captured = copy.deepcopy(model)
    # The device route's optimizer is capturable on the card, the host
    # route's not.
    opt = build_optimizer(model.parameters(), cfg.optim.optim_type,
                          cfg.optim.lr, cfg.optim.weight_decay,
                          capturable=cfg.runtime.device_dataset != "off")
    step, _ = make_train_step(model, opt, cfg.training.loss_fn,
                              node_level=node_level)
    if cfg.runtime.device_dataset == "off":
        dm.with_spmm_plan = True
        batches = list(dm.train_batches(epoch_seed=dm.seed))

        def make_batch(i):
            return batches[i % len(batches)].to("cuda")
    else:
        if not dm.enable_dense_slots():
            fail(f"{path.name}: the graphs do not fit dense slots")
        ds = DeviceDataset.build(dm.graphs, slot=dm.slot_nodes,
                                 device="cuda", with_cluster=True)
        perm = epoch_permutation(ds.num_graphs, cfg.data.batch_size, 0)
        rows = torch.as_tensor(perm, device="cuda")

        def make_batch(i):
            return assemble(ds, rows[i % len(rows)])
    profile_steps(label, step, make_batch, focus=focus)
    if cfg.runtime.device_dataset != "off":
        opt = build_optimizer(captured.parameters(), cfg.optim.optim_type,
                              cfg.optim.lr, cfg.optim.weight_decay,
                              capturable=True)
        train_epoch, _ = make_epoch_fn(
            captured, opt, ds, cfg.data.batch_size, len(perm),
            cfg.training.loss_fn, node_level=node_level,
            generator=torch.Generator(device="cuda").manual_seed(0))
        profile_replays(label, train_epoch, perm, focus=focus)


def phase_reference_hscn():
    """The VOC sparse HSCN at full width on a 4-graph batch, card (csr_spmm)
    against CPU (its plain version), with virtual_feedback on and nonzero
    VLDense weights, so that the lv and vv relations reach the logits:
    logits and every parameter gradient within 1e-4 * max|ref|.  First its
    SCN, the same weights on both sides, on the batch as clustering packs
    it (no plan): s, mc_loss and o_loss within 1e-4 * max|ref|, and equal
    assignments on every node whose top two values differ by more than
    1e-5; the HSCN batch carries the CPU's assignments."""
    import torch

    from graph_hscn_tpu_torch.config.config import load_config
    from graph_hscn_tpu_torch.data.batching import PadBudget, pack_batch
    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.models.hscn import build_hscn
    from graph_hscn_tpu_torch.models.scn import build_scn
    from graph_hscn_tpu_torch.ops import spmm
    from graph_hscn_tpu_torch.ops.cuda.spmm_kernel import csr_spmm
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    from graph_hscn_tpu_torch.train.loss import criterion

    cfg = load_config(VOC_HSCN)
    cfg.hscn.virtual_feedback = True
    set_matmul_precision(cfg.runtime.matmul_precision)
    dm = DataModule.from_config(cfg.data)
    graphs = dm.split("val")[:4]
    budget = PadBudget.for_dataset(graphs, 4)
    max_nodes = ((dm.max_nodes_per_graph() + 7) // 8) * 8
    gen = torch.Generator().manual_seed(2)
    scn = build_scn(cfg.hscn, dm.num_features, max_nodes, generator=gen)
    plain = pack_batch(graphs, budget)
    outs = {}
    with torch.no_grad():
        for dev in ("cpu", "cuda"):
            outs[dev] = [t.cpu() for t in copy.deepcopy(scn).to(dev)(
                plain.to(dev))]
    for ref, got, what in zip(outs["cpu"], outs["cuda"],
                              ("s", "mc_loss", "o_loss")):
        err = float((got - ref).abs().max())
        tol = 1e-4 * max(float(ref.abs().max()), 1e-3)
        if not got.isfinite().all() or err > tol:
            fail(f"SCN {what} card vs CPU: max |err| {err:.3e} > {tol:.3e}")
    mask = torch.as_tensor(plain.node_mask)
    s_cpu, s_card = outs["cpu"][0][mask], outs["cuda"][0][mask]
    top = s_cpu.topk(2, dim=-1).values
    clear = (top[:, 0] - top[:, 1]) > 1e-5
    same = s_cpu.argmax(-1) == s_card.argmax(-1)
    if not same[clear].all():
        fail(f"SCN assignments differ on {int((~same[clear]).sum())} nodes "
             "with a clear top-2 gap")
    assign = s_cpu.argmax(-1).numpy().astype(np.int32)
    sizes = np.cumsum([0] + [g.num_nodes for g in graphs])
    graphs = [g.replace(cluster=assign[a:b])
              for g, a, b in zip(graphs, sizes[:-1], sizes[1:])]
    print(f"[reference] SCN, 4-graph VOC batch: s and losses agree with the "
          f"CPU; assignments equal on {int(clear.sum())} of {len(assign)} "
          f"nodes with a clear top-2 gap ({int(same.sum())} equal in all), "
          f"{len(set(assign.tolist()))} clusters used", flush=True)

    batch = pack_batch(graphs, budget, with_spmm_plan=True)
    model = build_hscn(cfg.hscn, dm.num_features, dm.num_classes,
                       readout="none", generator=gen)
    with torch.no_grad():
        for vl in model.vl:
            vl.weight.normal_(0.0, 0.3, generator=gen)
    model.eval()
    grads = {}
    prev = spmm.get_backend()
    spmm.set_backend("pallas")    # the kernel path, plain versions on CPU
    try:
        for dev in ("cpu", "cuda"):
            m = copy.deepcopy(model).to(dev)
            b = batch.to(dev)
            before = csr_spmm.launches
            logits = m(b)
            loss, _ = criterion(cfg.training.loss_fn, logits, b.node_y,
                                b.node_mask)
            names, params = zip(*m.named_parameters())
            gs = torch.autograd.grad(loss, params, allow_unused=True)
            grads[dev] = [logits.detach()] + [
                torch.zeros_like(q) if g is None else g
                for q, g in zip(params, gs)]
            launched = csr_spmm.launches - before
    finally:
        spmm.set_backend(prev)
    want = 2 * cfg.hscn.num_layers
    if launched != want:
        fail(f"HSCN reference on the card: {launched} csr_spmm launches, "
             f"want {want}")
    worst = 0.0
    for name, ref, got in zip(("logits",) + names, grads["cpu"],
                              grads["cuda"]):
        err = float((got.cpu() - ref).abs().max())
        tol = 1e-4 * max(float(ref.abs().max()), 1e-3)
        if not got.isfinite().all() or err > tol:
            fail(f"VOC sparse HSCN {name} card vs CPU: max |err| {err:.3e} "
                 f"> {tol:.3e}")
        worst = max(worst, err / max(float(ref.abs().max()), 1e-3))
    live = [n for n, g in zip(names, grads["cpu"][1:])
            if n.startswith(("lv.0.", "vv.0.")) and g.abs().max() > 0]
    if not live:
        fail("VOC sparse HSCN with feedback: no gradient reaches lv/vv")
    print(f"[reference] {VOC_HSCN.name}, 4-graph batch "
          f"(N={batch.num_nodes_padded}, virtual_feedback on, VLDense "
          f"nonzero): logits and {len(names)} gradients agree with the CPU, "
          f"worst relative error {worst:.2e}; {launched} csr_spmm launches "
          f"on the card; nonzero gradients reach {live}", flush=True)


def phase_reference_fused():
    """The full-width FusedDenseGCN on a 4-graph peptides batch: the card
    (kernels) against the CPU (plain versions), logits and every parameter
    gradient."""
    import torch

    from graph_hscn_tpu_torch.data.batching import PadBudget, pack_batch
    from graph_hscn_tpu_torch.train.loss import criterion

    cfg, dm, _, model = peptides_setup(PEPTIDES_FUSED, fused=True)
    graphs = dm.split("val")[:4]
    batch = pack_batch(graphs, PadBudget.for_dataset(graphs, 4),
                       slot_nodes=dm.slot_nodes)
    model = model.cpu().eval()
    outs = {}
    for dev, m in (("cpu", model), ("cuda", copy.deepcopy(model).cuda())):
        b = batch.to(dev)
        logits = m(b)
        loss, _ = criterion(cfg.training.loss_fn, logits, b.y, b.graph_mask)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        outs[dev] = [logits.detach()] + list(grads)
    worst = 0.0
    for ref, got in zip(outs["cpu"], outs["cuda"]):
        err = float((got.cpu() - ref).abs().max())
        tol = 1e-4 * max(float(ref.abs().max()), 1e-3)
        if not got.isfinite().all() or err > tol:
            fail(f"fused card vs CPU: max |err| {err:.3e} > {tol:.3e}")
        worst = max(worst, err / max(float(ref.abs().max()), 1e-3))
    print(f"[reference] FusedDenseGCN, 4-graph peptides batch "
          f"(N={batch.num_nodes_padded}): logits and {len(outs['cpu']) - 1} "
          f"gradients agree with the CPU, worst relative error {worst:.2e}",
          flush=True)


class Interrupted(Exception):
    """What [resume] raises to cut a fit short, as a killed run stops."""


@contextlib.contextmanager
def interrupted_after(epoch: int):
    """Within the block, run_experiment's fits raise :class:`Interrupted`
    right after saving the latest snapshot of ``epoch``."""
    from graph_hscn_tpu_torch import runner
    from graph_hscn_tpu_torch.train.checkpoint import Checkpointer

    class Stopping(Checkpointer):
        def save_latest(self, state, e):
            super().save_latest(state, e)
            if e == epoch:
                raise Interrupted

    runner.Checkpointer = Stopping
    try:
        yield
    finally:
        runner.Checkpointer = Checkpointer


@contextlib.contextmanager
def recording_lr(into: list):
    """Within the block, every train row of the device route appends the
    lr its optimizer used (read back from the card after the row) to
    ``into``: the optimizers built are kept, and RowSteps.step of a train
    epoch (the one with accumulate/apply forms) reads the last one's."""
    from graph_hscn_tpu_torch.train import device_data, loop
    built = []
    build, step = loop.build_optimizer, device_data.RowSteps.step

    def keep(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    def recorded(self):
        step(self)
        if None not in self.bodies:          # a train epoch
            into.append(float(built[-1].opt.param_groups[0]["lr"]))

    loop.build_optimizer, device_data.RowSteps.step = keep, recorded
    try:
        yield
    finally:
        loop.build_optimizer, device_data.RowSteps.step = build, step


def resume_cfg(path: Path, directory: Path, changes: dict | None = None):
    """``path`` for 4 epochs, evaluated and snapshotted every epoch into
    ``directory``, no early stop."""
    shutil.rmtree(directory, ignore_errors=True)
    cfg = load_with(path, changes)
    cfg.training.epochs, cfg.training.eval_period = 4, 1
    cfg.training.checkpoint_every, cfg.training.patience = 1, 1000
    cfg.training.checkpoint_dir = str(directory)
    return cfg


def phase_resume(path: Path, expected, label: str, check_lr: bool = False,
                 changes: dict | None = None):
    """[resume] A 4-epoch fit uninterrupted, then again cut after epoch 1
    (its latest snapshot saved) and resumed by a fresh model, optimizer
    and Checkpointer: epochs 2-3's train losses within 1e-6 relative of
    the uninterrupted run's (the same arithmetic, captured or not, and the
    same dropout bits).  The resumed run's kernel launches, counted from
    its run alone, must be ``expected``'s; with ``check_lr``, the lr read
    back after every train row of both runs equals the schedule at that
    row's count of applied updates, within 1e-7.  Returns (the resumed
    run's launches, its FitResult, the config it ran).  ``changes`` are
    set on the config (``load_with``)."""
    import torch

    from graph_hscn_tpu_torch.runner import run_experiment
    from graph_hscn_tpu_torch.train.optimizers import learning_rate_schedule

    lrs_full, lrs_resumed = [], []
    with recording_lr(lrs_full):
        full = run_experiment(resume_cfg(path, SCRATCH / f"{label}_full",
                                         changes))
    cfg = resume_cfg(path, SCRATCH / label, changes)
    with interrupted_after(1):
        try:
            run_experiment(cfg)
        except Interrupted:
            pass
        else:
            fail(f"{path.name}: the cut run was not interrupted")
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    with recording_lr(lrs_resumed):
        resumed = run_experiment(cfg)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    want = dict.fromkeys(launches, 0)
    want.update(expected(cfg, resumed.num_train_steps,
                         resumed.num_eval_batches))
    epochs = [h["epoch"] for h in resumed.history]
    got = [h["train_loss"] for h in resumed.history]
    ref = [h["train_loss"] for h in full.history[2:]]
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    print(f"[resume] {path.name}: resumed at epochs {epochs}, train losses "
          f"{got} against {ref}, max relative difference {worst:.3e} "
          f"(limit 1e-6); {resumed.num_train_steps} train steps, "
          f"{resumed.num_eval_batches} eval batches, replays "
          f"{resumed.replays} (uninterrupted {full.replays}); launches "
          f"{launches} (expected {want})", flush=True)
    if epochs != [2, 3] or not worst <= 1e-6:
        fail(f"{path.name}: the resumed fit does not follow the "
             "uninterrupted one")
    if launches != want:
        fail(f"{path.name}: resumed launches {launches}, want {want}")
    snapshot_timing(path, SCRATCH / label)
    if check_lr:
        o, rows = cfg.optim, full.num_train_steps // 4
        sched = learning_rate_schedule(o.lr, o.schedule, o.warmup_steps,
                                       4 * rows)
        want_lr = sched(torch.arange(4 * rows, dtype=torch.float32)).tolist()
        errs = [abs(a - b) for a, b in
                zip(lrs_full + lrs_resumed, want_lr + want_lr[2 * rows:])]
        print(f"[resume] {path.name}: lr after every row, {len(lrs_full)} "
              f"uninterrupted and {len(lrs_resumed)} resumed (from row "
              f"{2 * rows}: {lrs_resumed[0]:.9g}, schedule "
              f"{want_lr[2 * rows]:.9g}); max |lr - schedule| "
              f"{max(errs):.3e} (limit 1e-7)", flush=True)
        if (len(lrs_full) != 4 * rows or len(lrs_resumed) != 2 * rows
                or not max(errs) <= 1e-7):
            fail(f"{path.name}: the resumed lr leaves the schedule")
    return launches, resumed, cfg


def snapshot_timing(path: Path, directory: Path, reps: int = 5) -> None:
    """[resume] The latest snapshot in ``directory`` restored onto the card
    (a tree of the sizes a fit saves: model, optimizer state, generator),
    then saved again ``reps`` times each way: synchronous (the whole write
    on the caller's thread) and asynchronous (the caller's share: the copy
    to host memory and the thread's start; the fence after, beside it).
    Prints the snapshot's bytes on disk and the median ms of each."""
    import torch

    from graph_hscn_tpu_torch.train.checkpoint import Checkpointer
    state, _ = Checkpointer(directory).restore("latest", "cuda")
    times = {"sync": [], "async": [], "fence": []}
    for mode in ("sync", "async"):
        ck = Checkpointer(SCRATCH / f"timing_{mode}",
                          async_writes=mode == "async")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save_latest(state, 0)
            t1 = time.perf_counter()
            ck.wait()
            times[mode].append((t1 - t0) * 1e3)
            if mode == "async":
                times["fence"].append((time.perf_counter() - t1) * 1e3)
    size = (SCRATCH / "timing_sync" / "latest").stat().st_size
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"[resume] {path.name}: snapshot {size} bytes; save_latest median "
          f"of {reps}: synchronous {med['sync']:.3f} ms, asynchronous "
          f"{med['async']:.3f} ms on the caller's thread (+{med['fence']:.3f}"
          f" ms to the fence)", flush=True)


def eval_batches(cfg) -> int:
    """The host batches run_eval scores for ``cfg`` (val and test)."""
    import torch

    from graph_hscn_tpu_torch.runner import _data
    from graph_hscn_tpu_torch.utils.logger import Logger
    dm = _data(cfg, torch.device("cuda"), Logger())
    return len(dm.eval_batches("val")) + len(dm.eval_batches("test"))


def phase_eval(cfg, best: float, expected, evals: int | None = None) -> dict:
    """[eval] run_eval(cfg, "best") after a fit into its checkpoint_dir:
    the val loss equal to the fit's best within rtol=1e-5, atol=1e-6 (the
    JAX package's criterion, tests/test_checkpoint.py:116-117), and the
    kernel launches ``expected(cfg, 0, eval batches)``; ``evals``: the
    eval forwards where they are not the host batches (an
    edge-partitioned run scores val and test in one forward each).
    Returns the launches."""
    from graph_hscn_tpu_torch.runner import run_eval
    n = eval_batches(cfg) if evals is None else evals
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    scores = run_eval(cfg, "best")
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    want = dict.fromkeys(launches, 0)
    want.update(expected(cfg, 0, n))
    val = scores["val"]["loss"]
    name = Path(cfg.training.checkpoint_dir).name
    print(f"[eval] {name}: run_eval best in {wall:.2f} s, {n} eval batches: "
          f"val loss {val!r} against the fit's best {best!r} "
          f"(|diff| {abs(val - best):.3e}, limit 1e-6 + 1e-5 * best); "
          f"scores {scores}; launches {launches} (expected {want})",
          flush=True)
    if not abs(val - best) <= 1e-6 + 1e-5 * abs(best):
        fail(f"{name}: eval-only val loss {val} is not the fit's best {best}")
    if launches != want:
        fail(f"{name}: eval launches {launches}, want {want}")
    return launches


def phase_predict(path: Path, directory: Path,
                  changes: dict | None = None) -> None:
    """[eval] ``python -m graph_hscn_tpu_torch.main --eval best --predict
    out.npz`` in a subprocess on ``path`` with its checkpoint_dir set to
    ``directory`` (and ``changes``, {"section.field": value} of the YAML):
    the .npz holds val and test scores and targets with the splits' real
    row counts (graphs, or nodes at node level)."""
    import yaml

    from graph_hscn_tpu_torch.data.pipeline import DataModule
    raw = yaml.safe_load(path.read_text())
    raw["training"]["checkpoint_dir"] = str(directory)
    for key, value in (changes or {}).items():
        section, field = key.split(".")
        raw[section][field] = value
    SCRATCH.mkdir(parents=True, exist_ok=True)
    cfg_file, out = SCRATCH / f"{path.stem}.yaml", SCRATCH / "out.npz"
    cfg_file.write_text(yaml.safe_dump(raw))
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "graph_hscn_tpu_torch.main", "--cfg",
         str(cfg_file), "--eval", "best", "--predict", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        fail(f"main --eval --predict exited {run.returncode}: "
             f"{run.stderr[-2000:]}")
    z = np.load(out)
    dm = DataModule.from_config(load_with(path).data)
    rows = {s: (len(dm.split_idx[s]) if dm.task_level == "graph" else
                sum(g.num_nodes for g in dm.split(s)))
            for s in ("val", "test")}
    shapes = {k: z[k].shape for k in sorted(z.files)}
    print(f"[eval] main --eval best --predict out.npz ({path.name}) in "
          f"{time.perf_counter() - t0:.1f} s: {shapes}, real rows {rows}",
          flush=True)
    if set(z.files) != {"val_scores", "val_targets", "test_scores",
                        "test_targets"}:
        fail(f"predict export holds {z.files}")
    for s, n in rows.items():
        for k in ("scores", "targets"):
            a = z[f"{s}_{k}"]
            if a.shape != (n, dm.num_classes) or not np.isfinite(a).all():
                fail(f"predict export {s}_{k}: shape {a.shape}, want "
                     f"({n}, {dm.num_classes}), finite")


def phase_cluster_routes(path: Path) -> None:
    """[eval] The HSCN clusters of the two routes on ``path`` as shipped:
    the host clustering (what run_eval re-runs) against the device
    route's captured clustering (what the device route trains with), from
    the same SCN weights.  Printed, not judged: JAX's run_eval re-clusters
    on the host too, so where the two differ, an eval-only score of an
    HSCN trained on the device route differs from its training run in
    both packages."""
    import torch

    from graph_hscn_tpu_torch import hscn_pipeline as hp
    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.train.clustering import train_clustering_device
    from graph_hscn_tpu_torch.train.device_data import DeviceDataset
    from graph_hscn_tpu_torch.utils.logger import Logger

    cfg = load_with(path)
    dm = DataModule.from_config(cfg.data)
    dm.enable_dense_slots()
    t0 = time.perf_counter()
    hp.cluster_on_host(cfg, dm, Logger(), torch.device("cuda"))
    host_s = time.perf_counter() - t0
    order = np.concatenate([dm.split_idx[s] for s in ("train", "val",
                                                      "test")])
    ds = DeviceDataset.build([dm.graphs[i] for i in order],
                             slot=dm.slot_nodes, device="cuda",
                             with_cluster=True)
    scn, _ = hp._models(cfg, dm, ds.slot, torch.device("cuda"), None)
    t0 = time.perf_counter()
    ds, _ = train_clustering_device(Logger(), ds, dm.batch_size, scn,
                                    cfg.hscn, cfg.optim,
                                    seed=cfg.training.seed)
    dev = ds.cluster.cpu().numpy()
    dev_s = time.perf_counter() - t0
    graphs_alike = nodes_alike = nodes = 0
    for i, g in enumerate(order):
        host = dm.graphs[g].cluster
        same = dev[i, :len(host)] == host
        graphs_alike += bool(same.all())
        nodes_alike += int(same.sum())
        nodes += len(host)
    print(f"[eval] {path.name}, {cfg.hscn.cluster_epochs} clustering epochs "
          f"each route: graphs clustered alike {graphs_alike} of "
          f"{len(order)}, nodes {nodes_alike} of {nodes} (host route "
          f"{host_s:.2f} s, device route {dev_s:.2f} s)", flush=True)


@contextlib.contextmanager
def timed_posenc(into: dict):
    """Within the block, runner's attach_posenc records its wall seconds
    (ending in a device sync) and the feature width it leaves."""
    import torch

    from graph_hscn_tpu_torch import runner
    attach = runner.attach_posenc

    def timed(dm, *args, **kwargs):
        t0 = time.perf_counter()
        attach(dm, *args, **kwargs)
        torch.cuda.synchronize()
        into.update(seconds=time.perf_counter() - t0, graphs=len(dm.graphs),
                    width=dm.num_features)

    runner.attach_posenc = timed
    try:
        yield
    finally:
        runner.attach_posenc = attach


def phase_pe() -> None:
    """[pe] configs/GCN/peptides_func_GCN_PE.yaml through run_experiment,
    captured and eager (capture_run): as shipped (the frozen SignNet
    transform on the card, then the GCN) and with
    compat.frozen_random_signnet false (EncodedModel inside the captured
    graphs); the transform's wall time and the feature width it leaves
    (9).  Then on a 4-graph batch, card against CPU: the trainable model
    (SignNet output, logits, every gradient) within 1e-4*max|ref| under
    matmul_precision highest; batched_eigh on the card against the host
    stats (float64, numpy's LAPACK in float64): eigenvalues within 1e-5,
    and the projector onto the k smallest eigenvectors (k <= 6, after the
    widest spectral gap) within 1e-4; in float32, reported."""
    info: dict = {}
    with timed_posenc(info):
        capture_run(PEPTIDES_PE, no_launches)
    print(f"[pe] {PEPTIDES_PE.name}: eigen stats and the frozen SignNet "
          f"transform over {info['graphs']} graphs in {info['seconds']:.2f} "
          f"s wall; feature width after {info['width']}", flush=True)
    if info["width"] != 9:
        fail(f"PE transform left width {info['width']}, want 9")
    capture_run(PEPTIDES_PE, no_launches, TRAINABLE_PE)
    phase_reference_pe()


def phase_reference_pe() -> None:
    import torch

    from graph_hscn_tpu_torch.data.batching import PadBudget, pack_batch
    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.runner import _model, set_matmul_precision
    from graph_hscn_tpu_torch.train.loss import criterion
    from graph_hscn_tpu_torch.transform.posenc import (batched_eigh,
                                                       compute_posenc_stats)
    from graph_hscn_tpu_torch.utils.logger import Logger

    cfg = load_with(PEPTIDES_PE, TRAINABLE_PE)
    set_matmul_precision("highest")
    dm = DataModule.from_config(cfg.data)
    dm.enable_dense_slots()
    pe = cfg.pe
    graphs = [compute_posenc_stats(g, pe.eigen_max_freqs, pe.eigvec_norm,
                                   pe.eigen_laplacian_norm)
              for g in dm.split("val")[:4]]
    batch = pack_batch(graphs, PadBudget.for_dataset(graphs, 4),
                       slot_nodes=dm.slot_nodes)
    model = _model(cfg, dm, torch.device("cpu"), None, Logger()).eval()
    outs = {}
    for dev, m in (("cpu", model), ("cuda", copy.deepcopy(model).cuda())):
        b = batch.to(dev)
        enc = m.encoder(b)
        logits = m(b)
        loss, _ = criterion(cfg.training.loss_fn, logits, b.y, b.graph_mask)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        outs[dev] = [enc.detach(), logits.detach()] + list(grads)
    worst = 0.0
    for ref, got in zip(outs["cpu"], outs["cuda"]):
        err = float((got.cpu() - ref).abs().max())
        tol = 1e-4 * max(float(ref.abs().max()), 1e-3)
        if not got.isfinite().all() or err > tol:
            fail(f"EncodedModel card vs CPU: max |err| {err:.3e} > {tol:.3e}")
        worst = max(worst, err / max(float(ref.abs().max()), 1e-3))
    print(f"[reference] EncodedModel (SignNet + GCN), 4-graph peptides batch "
          f"(N={batch.num_nodes_padded}): SignNet output, logits and "
          f"{len(outs['cpu']) - 2} gradients agree with the CPU, worst "
          f"relative error {worst:.2e}", flush=True)

    n_max = max(g.num_nodes for g in graphs)
    adj = np.zeros((4, n_max, n_max))
    mask = np.zeros((4, n_max), bool)
    for i, g in enumerate(graphs):
        np.add.at(adj[i], (g.edge_index[1], g.edge_index[0]), 1.0)
        mask[i, :g.num_nodes] = True
    hosts = [compute_posenc_stats(g, max_freqs=g.num_nodes) for g in graphs]
    for dtype in (torch.float64, torch.float32):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evals, evects = batched_eigh(torch.from_numpy(adj).to("cuda", dtype),
                                     torch.from_numpy(mask).cuda())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        val_err, proj_err, ks = eigen_errors(evals.cpu().numpy(),
                                             evects.cpu().numpy(), hosts)
        judged = dtype == torch.float64
        print(f"[pe] batched_eigh on the card ({dtype}, 4 graphs, n_max "
              f"{n_max}) in {ms:.2f} ms wall with its first call: "
              f"eigenvalues within {val_err:.2e} of the host stats, "
              f"projectors (k, gap) {ks} within {proj_err:.2e}"
              + (" (limits 1e-5 and 1e-4)" if judged else " (reported)"),
              flush=True)
        if judged and not (val_err <= 1e-5 and proj_err <= 1e-4):
            fail("batched_eigh on the card disagrees with the host stats")


def eigen_errors(evals, evects, hosts) -> tuple:
    """batched_eigh's output for each graph against its host stats (all n
    pairs): the largest eigenvalue error, and the largest error of the
    projector onto the k smallest eigenvectors, k <= 6 after the widest
    spectral gap there; with each graph's (k, gap)."""
    val_err = proj_err = 0.0
    ks = []
    for i, host in enumerate(hosts):
        n = host.num_nodes
        # Padding adds eigenvalue-1 pairs with no support on real nodes.
        real = np.sort(np.argsort(-np.abs(evects[i, :n]).sum(0))[:n])
        lam, vec = evals[i][real], evects[i, :n][:, real]
        val_err = max(val_err, float(np.abs(lam - host.eigvals[0]).max()))
        k = 1 + int(np.argmax(np.diff(lam[:7])))
        ks.append((k, round(float(lam[k] - lam[k - 1]), 6)))
        p = vec[:, :k].astype(np.float64)
        q = host.eigvecs[:, :k].astype(np.float64)
        proj_err = max(proj_err, float(np.abs(p @ p.T - q @ q.T).max()))
    return val_err, proj_err, ks


def ep_launches(cfg, steps, evals):
    """The edge-partitioned fit (parallel/sharded_gcn.py): a layer whose
    local aggregation takes the kernels (its F, or H*C for GAT, at least
    WIDTH_GATE) launches, GCN, csr_spmm forward and transpose in a train
    step and forward in an eval forward; GAT, spmm_mh forward and dx and
    sddmm_mh (d alpha) in a train step, spmm_mh forward in an eval
    forward; GatedGCN (every layer hidden wide), segment_reduce 2 a layer
    forward (the local sums) and 3 backward (the local gathers),
    parallel/sharded_gatedgcn.py; GIN and GPS nothing; the HSCN pipeline,
    csr_spmm forward and transpose in each layer's ll GCN (hidden wide) in
    a train step, forward in an eval forward (``voc_hscn_launches``; its
    SCN stack aggregates the 14 input features, below the gate).
    ``evals`` counts the eval forwards (val, test, and the train metric's
    on an eval epoch)."""
    from graph_hscn_tpu_torch.parallel.sharded_gcn import WIDTH_GATE
    if cfg.hscn is not None:
        return voc_hscn_launches(cfg, steps, evals)
    conv = cfg.mpnn.conv_type.lower()
    if conv == "gatedgcn":
        k = (cfg.mpnn.num_layers
             if cfg.mpnn.hidden_channels >= WIDTH_GATE else 0)
        return {"segment_reduce": 5 * k * steps + 2 * k * evals}
    heads = cfg.mpnn.num_heads if conv == "gat" else 1
    widths = ([cfg.mpnn.hidden_channels] * (cfg.mpnn.num_layers - 1)
              + [heads * VOC_CLASSES])
    k = sum(w >= WIDTH_GATE for w in widths)
    if conv == "gcn":
        return {"csr_spmm": 2 * k * steps + k * evals}
    if conv == "gat":
        return {"spmm_mh": 2 * k * steps + k * evals, "sddmm_mh": k * steps}
    return {}


def ep_split(dm, name: str, mesh, cfg, use_plan: bool):
    """fit_edge_partitioned's packing of split ``name``: its block with
    the graph ids a GPS needs."""
    from graph_hscn_tpu_torch.parallel.sharded_gcn import partition_split
    conv = cfg.mpnn.conv_type.lower()
    return partition_split(dm.split(name), mesh, cfg.mesh.locality_reorder,
                           use_plan, edges=True, graph_ids=conv == "gps")


def ep_setup(path: Path, changes: dict, device):
    """(cfg, dm, conv, the sharded model from seed 0 on ``device``, the
    mesh) of an edge-partition config on a 1-rank mesh, within a process
    group (no dropout: the card and the CPU draw other bits)."""
    import torch

    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.parallel.mesh import make_mesh
    from graph_hscn_tpu_torch.parallel.sharded_gcn import build_sharded_model
    from graph_hscn_tpu_torch.runner import set_matmul_precision

    cfg = load_with(path, changes)
    set_matmul_precision(cfg.runtime.matmul_precision)
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    conv = cfg.mpnn.conv_type.lower()
    dims = ([dm.num_features]
            + [cfg.mpnn.hidden_channels] * (cfg.mpnn.num_layers - 1)
            + [dm.num_classes])
    model = build_sharded_model(conv, dims, heads=cfg.mpnn.num_heads,
                                generator=torch.Generator().manual_seed(0),
                                local_conv=cfg.mpnn.gps_local_conv.lower(),
                                hidden=cfg.mpnn.hidden_channels)
    return cfg, dm, conv, model.to(device), make_mesh(("data",), (1,),
                                                      device)


def phase_edge_partition_kernels() -> None:
    """csr_spmm (B1) and spmm_mh / sddmm_mh (B6, B7) at the edge-partition
    block: the train split of ``GCN_EP`` packed, locality-reordered and
    planned as fit_edge_partitioned does on one rank (its local-edge
    CsrPlan), on the card.  csr_spmm forward and transpose at F = 64 with
    the block's GCN weights (``check_spmm_batch``); spmm_mh forward and
    transpose and sddmm_mh (d alpha) at H = 4, C = 16 and 21, float32
    (``time_case``, each held at 1e-5 * max|ref|)."""
    import torch

    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.parallel.mesh import make_mesh, process_group
    from graph_hscn_tpu_torch.parallel.sharded_gcn import partition_split

    cfg = load_with(GCN_EP, ONE_RANK)
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    with process_group(torch.device("cuda")) as device:
        split = partition_split(dm.split("train"),
                                make_mesh(("data",), (1,), device),
                                cfg.mesh.locality_reorder, use_plan=True)
        blk = split.block
        w = blk.gcn_norm()[0]
        p = blk.csr
        i = split.info
        print(f"[edge_partition] block: N_b={i['block_rows']} rows, "
              f"E={i['edges']} real edges ({p.col.numel()} slots with "
              f"padding), H={i['halo_width']}, host plan "
              f"{i['seconds']:.3f} s", flush=True)
        check_spmm_batch("edge-partition block", p, w,
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
        # segment_reduce (B5) at the GatedGCN config's train block: the
        # local sums (receiver side) and the local gathers' backwards
        # (sender side, t_order), F = hidden, float32.
        gcfg = load_with(GATED_EP, ONE_RANK)
        gdm = DataModule.from_config(gcfg.data,
                                     pad_safety=gcfg.runtime.pad_safety)
        mesh = make_mesh(("data",), (1,), device)
        split = ep_split(gdm, "train", mesh, gcfg, True)
        p, i = split.block.csr, split.info
        print(f"[edge_partition] GatedGCN block: N_b={i['block_rows']} rows,"
              f" {p.num_edges} local edges ({p.col.numel()} slots), "
              f"F={gcfg.mpnn.hidden_channels}", flush=True)
        msgs = torch.randn(p.col.numel(), gcfg.mpnn.hidden_channels,
                           device="cuda", generator=gen)
        for side, rp, order in (("receiver", p.row_ptr, None),
                                ("sender", p.t_row_ptr, p.t_order)):
            segment_reduce_case("[edge_partition] GatedGCN block", side,
                                msgs, rp, order, p.num_edges)
        del split, msgs
        # csr_spmm (B1) at the HSCN config's train block: the ll GCN's
        # weights (in-degree normalisation, no self loops), F = hidden.
        hcfg = load_with(HSCN_EP)
        hdm = DataModule.from_config(hcfg.data,
                                     pad_safety=hcfg.runtime.pad_safety)
        split = partition_split(hdm.split("train"), mesh,
                                hcfg.mesh.locality_reorder, use_plan=True)
        print(f"[edge_partition] HSCN block: N_b="
              f"{split.info['block_rows']} rows, {split.block.csr.num_edges}"
              " local edges", flush=True)
        check_spmm_batch("edge-partition HSCN block", split.block.csr,
                         split.block.gcn_norm(self_loops=False)[0],
                         [("forward", hcfg.hscn.hidden_channels),
                          ("transpose", hcfg.hscn.hidden_channels)])


def phase_edge_partition(path: Path, changes: dict, label: str,
                         focus: dict | None = None, profiled: int = 6,
                         steady: int = 10) -> None:
    """[edge_partition] An edge-partition config on a 1-rank NCCL mesh at
    full width: its full-batch train step (``loss_and_grads``, the
    all_reduce, AdamW) profiled over the train split's block (device busy
    time, idle share, the kernels' and NCCL's device time); then the model
    on the val split, card (the kernels) against the CPU (a 1-rank gloo
    mesh, plain versions): logits within 1e-5 * max|ref|, the loss and
    every gradient within 1e-4 * max|ref|, the gradients on the card's
    activation pattern (``KinkPins``).  ``profiled`` and ``steady``: the
    steps profiled and then timed."""
    import torch

    from graph_hscn_tpu_torch.parallel.mesh import make_mesh, process_group
    from graph_hscn_tpu_torch.parallel.sharded_gcn import (KERNEL_CONVS,
                                                           loss_and_grads)
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer

    outs = {}
    with process_group(torch.device("cuda")) as device:
        cfg, dm, conv, model, mesh = ep_setup(path, changes, device)
        train = ep_split(dm, "train", mesh, cfg, conv in KERNEL_CONVS)
        opt = build_optimizer(model.parameters(), cfg.optim.optim_type,
                              cfg.optim.lr, cfg.optim.weight_decay)

        def step(_):
            model.train()
            loss_and_grads(model, train.block)
            opt.step()

        ep_step_times(label, step, focus, profiled, steady)
        del train
        val = ep_split(dm, "val", mesh, cfg, conv in KERNEL_CONVS)
        pins = KinkPins()
        outs["cuda"] = reference_outputs(model, val.block, pins.record())
        state = {k: v.cpu() for k, v in model.state_dict().items()}
    with process_group(torch.device("cpu")) as device:
        model = model.cpu()
        model.load_state_dict(state)
        val = ep_split(dm, "val", make_mesh(("data",), (1,), device), cfg,
                       False)
        outs["cpu"] = reference_outputs(model, val.block, pins.replay())
    card_against_cpu(label, outs, pins, val.info,
                     [name for name, _ in model.named_parameters()])


def ep_step_times(label: str, step, focus: dict | None, profiled: int,
                  steady: int) -> None:
    """An edge-partitioned train ``step`` profiled (``profile_steps``:
    busy time, idle share, ``focus``'s groups and NCCL's) over
    ``profiled`` steps, then ``steady`` steps on the synchronised host
    clock."""
    import torch

    profile_steps(f"edge-partition {label}", step, lambda i: None,
                  steps=profiled,
                  focus={**(focus or {}),
                         "NCCL kernels and copies (halo all_to_all, "
                         "all_reduce)": ("nccl", "Memcpy")})
    ms = []
    for _ in range(steady):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(None)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[edge_partition] {label} steady train step ms (synchronised "
          f"host clock, {steady} steps after the profiled ones): median "
          f"{statistics.median(ms):.3f}, min {min(ms):.3f}, max "
          f"{max(ms):.3f}", flush=True)


def phase_edge_partition_hscn(profiled: int = 6, steady: int = 10) -> None:
    """[edge_partition] The HSCN edge-partition config as shipped on a
    1-rank NCCL mesh at full width: the sharded SCN (seed 0) assigns the
    train and val splits' clusters; the sharded HSCN's full-batch train
    step profiled over the train block (``ep_step_times``); then on the
    val split the card against the CPU (1-rank gloo, plain versions): the
    SCN's MinCUT and orthogonality losses within 1e-5 relative, and the
    HSCN's logits, loss and gradients with the card's clusters as
    :func:`card_against_cpu` holds them (``KinkPins``)."""
    import torch

    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.parallel.mesh import make_mesh, process_group
    from graph_hscn_tpu_torch.parallel.sharded_gcn import (loss_and_grads,
                                                           partition_split)
    from graph_hscn_tpu_torch.parallel.sharded_hscn import ShardedHSCN
    from graph_hscn_tpu_torch.parallel.sharded_scn import ShardedSCN
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer

    cfg = load_with(HSCN_EP)
    set_matmul_precision(cfg.runtime.matmul_precision)
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    h, gen = cfg.hscn, torch.Generator().manual_seed(0)
    scn = ShardedSCN(dm.num_features, h.mp_units, h.num_clusters,
                     h.activation, generator=gen)
    model = ShardedHSCN(
        dm.num_features, h.hidden_channels, dm.num_classes, h.num_layers,
        h.num_clusters, heads=h.num_heads,
        virtual_feedback=h.virtual_feedback,
        vv_pattern=("triangular" if cfg.compat.vv_triangular_pattern
                    else "clique"), generator=gen)

    def split(name, mesh, use_plan):
        return partition_split(dm.split(name), mesh,
                               cfg.mesh.locality_reorder, use_plan,
                               outdeg=True)

    outs, losses = {}, {}
    with process_group(torch.device("cuda")) as device:
        mesh = make_mesh(("data",), (1,), device)
        scn, model = scn.to(device), model.to(device)
        train = split("train", mesh, True)
        clusters = scn.assign(train.block)
        opt = build_optimizer(model.parameters(), cfg.optim.optim_type,
                              cfg.optim.lr, cfg.optim.weight_decay)

        def step(_):
            model.train()
            loss_and_grads(model, train.block, clusters)
            opt.step()

        ep_step_times("HSCN", step, GCN_FOCUS, profiled, steady)
        del train
        val = split("val", mesh, True)
        with torch.no_grad():
            losses["cuda"] = [float(t) for t in scn.losses(val.block)]
        clusters = scn.assign(val.block)
        pins = KinkPins()
        outs["cuda"] = reference_outputs(model, val.block, pins.record(),
                                         clusters)
        states = [{k: v.cpu() for k, v in m.state_dict().items()}
                  for m in (scn, model)]
    with process_group(torch.device("cpu")) as device:
        for m, state in zip((scn.cpu(), model.cpu()), states):
            m.load_state_dict(state)
        val = split("val", make_mesh(("data",), (1,), device), False)
        with torch.no_grad():
            losses["cpu"] = [float(t) for t in scn.losses(val.block)]
        outs["cpu"] = reference_outputs(model, val.block, pins.replay(),
                                        clusters.cpu())
    err = max(abs(a - b) / max(abs(b), 1e-12)
              for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"[reference] edge-partition HSCN, val split: the SCN's MinCUT and "
          f"orthogonality losses {losses['cuda']} on the card, "
          f"{losses['cpu']} on the CPU: max relative difference {err:.2e} "
          "(limit 1e-5)", flush=True)
    if not err <= 1e-5:
        fail("edge-partition HSCN: the SCN's losses differ between the card "
             "and the CPU")
    card_against_cpu("HSCN", outs, pins, val.info,
                     [name for name, _ in model.named_parameters()])


# Parameters whose gradient is zero in exact arithmetic: the attention's
# key bias shifts all of a query's scores alike (GPS), so its gradient is
# rounding alone, held against the largest gradient of all (the CPU
# tests' criterion, tests/test_torch_gps.py).
EXACT_ZERO_GRADS = ("attn.k.bias",)


def card_against_cpu(label: str, outs: dict, pins, info: dict,
                     names: list) -> None:
    """[reference] ``outs["cuda"]`` against ``outs["cpu"]`` (logits, loss,
    every gradient: :func:`reference_outputs`, the parameters ``names``):
    the logits within 1e-5 * max|ref|, the rest within 1e-4 * max|ref|
    (``EXACT_ZERO_GRADS``: of the largest gradient), and at most 1e-5 of
    the activation decisions flipped (``pins``)."""
    top = max(float(g.abs().max()) for g in outs["cpu"][2:])
    if pins.flips > 1e-5 * pins.count:
        fail(f"edge-partition {label}: {pins.flips} of {pins.count} "
             "activation decisions differ between the card and the CPU "
             "(rounding flips a handful; limit 1e-5 of them)")
    worst = []
    for i, (ref, got) in enumerate(zip(outs["cpu"], outs["cuda"])):
        scale = max(float(ref.abs().max()), 1e-6)
        if i >= 2 and names[i - 2].endswith(EXACT_ZERO_GRADS):
            scale = top
        err = float((got.cpu() - ref).abs().max())
        tol = (1e-5 if i == 0 else 1e-4) * scale
        if not got.isfinite().all() or err > tol:
            fail(f"edge-partition {label} card vs CPU, output {i}: max "
                 f"|err| {err:.3e} > {tol:.3e}")
        worst.append(err / scale)
    print(f"[reference] edge-partition {label}, val split (N={info['rows']}"
          f", {info['edges']} edges): logits max |err| / max|ref| "
          f"{worst[0]:.2e} (limit 1e-5); loss and {len(worst) - 2} "
          f"gradients worst {max(worst[1:]):.2e} (limit 1e-4; {pins.flips} "
          f"of {pins.count} activation decisions differed on the CPU and "
          "took the card's)", flush=True)


class KinkPins:
    """The ReLU and leaky-ReLU decisions (``x > 0``, ``x >= 0``) of the
    sharded models (``parallel/sharded_gcn.py``, ``sharded_gatedgcn.py``:
    the ReLUs after LayerNorm; ``sharded_gps.py``: the local convs' ReLUs;
    ``sharded_hscn.py``: its ReLUs and the lv leaky ReLU), recorded on one
    run and replayed, in the same order, on another.

    The gradient of a piecewise-linear network jumps where a
    pre-activation crosses 0.  Of the ~2e7 decisions of a val-split
    gradient, the card's float32 and the CPU's may put a few on opposite
    sides (rounding apart, both right): the parameter gradient that sums
    over such a row then differs by a whole term, ~2e-4 * max|ref| at this
    size (seen on the H100 with 2 such decisions, while every gradient
    agreed within 3e-6 with them replayed).  The CPU's gradient pass takes
    the card's decisions, so both are held on the same linear piece; its
    own decisions that differed are counted in ``flips``."""

    def __init__(self):
        self.masks, self.flips, self.count = [], 0, 0

    @contextlib.contextmanager
    def record(self):
        self.masks = []

        def keep(m):
            self.masks.append(m.cpu())
            return m

        with self._patched(keep):
            yield
        self.count = sum(m.numel() for m in self.masks)

    @contextlib.contextmanager
    def replay(self):
        queue = iter(self.masks)
        self.flips = 0

        def take(m):
            card = next(queue, None)
            if card is None or card.shape != m.shape:
                fail("KinkPins: the replayed run's activation decisions do "
                     "not follow the recorded one's")
            card = card.to(m.device)
            self.flips += int((card != m).sum())
            return card

        with self._patched(take):
            yield
        if next(queue, None) is not None:
            fail("KinkPins: the replayed run made fewer activation "
                 "decisions than the recorded one")

    @staticmethod
    @contextlib.contextmanager
    def _patched(decide):
        import types

        import torch
        import torch.nn.functional as F

        from graph_hscn_tpu_torch.models.layers import GAT_NEGATIVE_SLOPE
        from graph_hscn_tpu_torch.parallel import (sharded_gatedgcn,
                                                   sharded_gcn, sharded_gps,
                                                   sharded_hscn)

        def relu(x):
            return torch.where(decide(x > 0), x, 0.0)

        def leaky_relu(x):
            return torch.where(decide(x >= 0), x, GAT_NEGATIVE_SLOPE * x)

        functional = types.SimpleNamespace(**{
            k: getattr(F, k) for k in dir(F) if not k.startswith("_")})
        functional.relu = relu
        patched = [(m, "F", functional) for m in (
            sharded_gcn, sharded_gatedgcn, sharded_gps, sharded_hscn)]
        patched += [(m, "leaky_relu", leaky_relu)
                    for m in (sharded_gcn, sharded_hscn)]
        saved = [(m, name, getattr(m, name)) for m, name, _ in patched]
        for m, name, value in patched:
            setattr(m, name, value)
        try:
            yield
        finally:
            for m, name, value in saved:
                setattr(m, name, value)


def kink_study(snapshots: int) -> None:
    """``--kink-study N``: what the activation pins do.  For each
    edge-partition model (1-rank mesh, full width), N weight states 3
    AdamW steps apart on the card; at each, the val split's outputs on the
    card twice (its own run-to-run spread) and on the CPU unpinned and
    pinned to the card's decisions: the worst relative error of the
    gradients each way, and the decisions that differed."""
    import torch

    from graph_hscn_tpu_torch.parallel.mesh import make_mesh, process_group
    from graph_hscn_tpu_torch.parallel.sharded_gcn import (
        KERNEL_CONVS, loss_and_grads, partition_split)
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer

    def worst(got, ref):
        return max(float((g.cpu() - r).abs().max())
                   / max(float(r.abs().max()), 1e-6)
                   for g, r in zip(got[2:], ref[2:]))

    for path, changes, label in ((GAT_EP, ONE_RANK, "GAT"),
                                 (GCN_EP, ONE_RANK, "GCN"),
                                 (GCN_EP, GIN_EP, "GIN")):
        states = []
        with process_group(torch.device("cuda")) as device:
            cfg, dm, conv, model, mesh = ep_setup(path, changes, device)
            reorder = cfg.mesh.locality_reorder
            train = partition_split(dm.split("train"), mesh, reorder,
                                    conv in KERNEL_CONVS)
            val = partition_split(dm.split("val"), mesh, reorder,
                                  conv in KERNEL_CONVS)
            opt = build_optimizer(model.parameters(), cfg.optim.optim_type,
                                  cfg.optim.lr, cfg.optim.weight_decay)
            for _ in range(snapshots):
                for _ in range(3):
                    model.train()
                    loss_and_grads(model, train.block)
                    opt.step()
                pins = KinkPins()
                card = reference_outputs(model, val.block, pins.record())
                again = reference_outputs(model, val.block)
                states.append(({k: v.cpu() for k, v in
                                model.state_dict().items()}, pins,
                               [t.cpu() for t in card], again))
            del train, val
        with process_group(torch.device("cpu")) as device:
            model = model.cpu()
            val = partition_split(dm.split("val"), make_mesh(
                ("data",), (1,), device), reorder)
            for i, (state, pins, card, again) in enumerate(states):
                model.load_state_dict(state)
                free = reference_outputs(model, val.block)
                pinned = reference_outputs(model, val.block, pins.replay())
                print(f"[kinks] {label} state {i} (step {3 * (i + 1)}): "
                      f"gradients' max |err| / max|ref|, card again "
                      f"{worst(again, card):.2e}, CPU unpinned "
                      f"{worst(card, free):.2e}, CPU pinned "
                      f"{worst(card, pinned):.2e}; {pins.flips} of "
                      f"{pins.count} decisions differed", flush=True)


def reference_outputs(model, blk, pins=None, clusters=None) -> list:
    """[logits, loss, every gradient] of the sharded model on a block (an
    HSCN with its ``clusters``); the gradient pass within ``pins`` (a
    ``KinkPins`` context) where given."""
    from graph_hscn_tpu_torch.parallel.sharded_gcn import (gather_logits,
                                                           loss_and_grads)
    args = () if clusters is None else (clusters,)
    logits = gather_logits(model, blk, *args)
    model.train()
    with pins or contextlib.nullcontext():
        loss = loss_and_grads(model, blk, *args)
    return [logits, loss.reshape(1)] + [p.grad.clone()
                                        for p in model.parameters()]


def phase_edge_partition_runs() -> dict:
    """The edge-partition configs through the port's entry points on one
    card ([edge_partition] train lines: N_b, E, H, the host plan's
    seconds, step ms; profiles and card-vs-CPU references; [resume] and
    [eval] of the GCN one, the predict export in a subprocess).  Returns
    the kernels' launches of the train, resumed and eval runs."""
    from collections import Counter
    launches = Counter()
    for path, changes, label, focus, steps in (
            (GCN_EP, ONE_RANK, "GCN", GCN_FOCUS, {}),
            (GAT_EP, ONE_RANK, "GAT", GAT_FOCUS, {}),
            (GCN_EP, GIN_EP, "GIN", None, {}),
            (GATED_EP, ONE_RANK, "GatedGCN", GATED_FOCUS, {}),
            (GPS_VOC, GPS_EP, "GPS", None, {"profiled": 2, "steady": 2}),
            (HSCN_EP, None, "HSCN", GCN_FOCUS, {})):
        # The HSCN config as shipped: mesh.shape [-1], 5 clustering epochs.
        got, result = train_run(path, ep_launches, "edge_partition",
                                changes, cluster_epochs=None)[:2]
        launches.update(got)
        for split, i in result.partition.items():
            print(f"[edge_partition] {label} {split}: N_b={i['block_rows']} "
                  f"rows, E={i['edges']} real edges (local "
                  f"{i['local_edges']}, halo {i['halo_edges']}), "
                  f"H={i['halo_width']}, host plan {i['seconds']:.3f} s",
                  flush=True)
        if path == HSCN_EP:
            phase_edge_partition_hscn()
        else:
            phase_edge_partition(path, changes, label, focus, **steps)
    for path, changes, label in ((GCN_EP, ONE_RANK, "ep_gcn"),
                                 (HSCN_EP, None, "ep_hscn")):
        resumed, fit, cfg = phase_resume(path, ep_launches, label,
                                         changes=changes)
        launches.update(resumed)
        launches.update(phase_eval(cfg, fit.best_val_loss, ep_launches,
                                   evals=2))
    phase_predict(GCN_EP, SCRATCH / "ep_gcn", ONE_RANK)
    return dict(launches)


# --- [dp], [hybrid], [loader] -----------------------------------------------

def run_dp(cfg, step_timing: bool = True):
    """``fit_dp`` of ``cfg`` on a 1-rank NCCL group (run_experiment's
    ``data_parallel``: the model and data as the runner builds them)."""
    from graph_hscn_tpu_torch.runner import run_experiment
    return run_experiment(cfg, step_timing=step_timing, data_parallel=True)


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


def run_dp_reference(cfg, step_timing: bool = True):
    """The single-device host ``fit`` on fit_dp's global batches (the
    same model from the same seed): one rank's DP update is this
    update."""
    import torch

    from graph_hscn_tpu_torch.runner import _data, _model, _setup_run
    from graph_hscn_tpu_torch.train.loop import fit
    from graph_hscn_tpu_torch.utils.logger import Logger
    device, dtype = _setup_run(cfg, torch.device("cuda"))
    logger = Logger(metric_name=cfg.training.metric)
    dm = _data(cfg, device, logger)
    model = _model(cfg, dm, device, dtype, logger)
    seed = cfg.training.seed
    return fit(model,
               lambda epoch: dp_global_batches(dm, "train", seed + epoch),
               list(dp_global_batches(dm, "val", None)),
               list(dp_global_batches(dm, "test", None)), cfg.optim,
               cfg.training, logger, device,
               compat_sigmoid_score=cfg.compat.sigmoid_regression_score,
               step_timing=step_timing)


def dp_profile(changes: dict, label: str) -> None:
    """[dp] fit_dp's train step (pack_for_devices' one-rank batches,
    uploaded beforehand) profiled on a 1-rank NCCL group: device busy
    time, idle share, the kernels by device time."""
    import torch

    from graph_hscn_tpu_torch.parallel.data_parallel import make_dp_train_step
    from graph_hscn_tpu_torch.parallel.mesh import make_mesh, process_group
    from graph_hscn_tpu_torch.runner import _data, _model, _setup_run
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer
    from graph_hscn_tpu_torch.utils.logger import Logger
    cfg = load_with(DP8, changes)
    device, dtype = _setup_run(cfg, torch.device("cuda"))
    logger = Logger(metric_name=cfg.training.metric, quiet=True)
    with process_group(device) as device:
        dm = _data(cfg, device, logger)
        model = _model(cfg, dm, device, dtype, logger)
        opt = build_optimizer(model.parameters(), cfg.optim.optim_type,
                              cfg.optim.lr, cfg.optim.weight_decay)
        step = make_dp_train_step(model, opt, cfg.training.loss_fn,
                                  make_mesh(("data",), (1,), device))
        batches = [b.to(device) for b in itertools.islice(
            dp_global_batches(dm, "train", 0), 3)]
        profile_steps(f"[dp] {label}", lambda b: step(b, 0),
                      lambda i: batches[i % len(batches)],
                      focus={"NCCL (the count's and the gradients' "
                             "all_reduce)": ("nccl",)})


def losses_agree(label: str, got, want, rtol: float) -> float:
    """Every epoch's train, val and test loss of two fits within ``rtol``
    relative; returns the largest relative difference."""
    worst = 0.0
    for a, b in zip(got.history, want.history, strict=True):
        for key in ("train_loss", "validation_loss", "test_loss"):
            rel = abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
            worst = max(worst, rel)
    print(f"{label}: per-epoch losses' largest relative difference "
          f"{worst:.3e} (limit {rtol:.0e})", flush=True)
    if not worst <= rtol:
        fail(f"{label}: losses differ by {worst:.3e} relative")
    return worst


def phase_dp() -> dict:
    """[dp] configs/GCN/peptides_func_GCN_dp8.yaml's widths (global batch
    128, hidden 128, 5 layers, slot 392) through fit_dp on a 1-rank NCCL
    group, 2 epochs without dropout: the losses within 1e-5 relative of
    the single-device fit on the same global batches; then its
    runtime.fused_stack: on twin (fused_gcn_fwd/bwd) and its
    runtime.dense_path: sparse twin (csr_spmm), launches counted; step ms,
    idle share and peak memory of each; B1 at the sparse twin's first
    batch (F = 128 and 10, forward and transpose) and B2f/B2b at the
    fused twin's shape (G = 128, S = 392) against their plain versions.
    Returns the runs' launches."""
    import torch
    from collections import Counter

    from graph_hscn_tpu_torch.ops.spmm import gcn_norm_weights
    from graph_hscn_tpu_torch.runner import _data
    from graph_hscn_tpu_torch.utils.logger import Logger

    launches = Counter()
    got, dense, _, _ = train_run(DP8, no_launches, "dp", DP_ONE, run=run_dp)
    launches.update(got)
    ref = train_run(DP8, no_launches, "dp reference", DP_ONE,
                    run=run_dp_reference)[1]
    losses_agree("[dp] fit_dp at one rank against the single-device fit",
                 dense, ref, 1e-5)
    dp_profile(DP_ONE, "dense MPNN")
    for changes, expected, label in ((DP_FUSED, fused_launches, "fused"),
                                     (DP_SPARSE, voc_gcn_launches,
                                      "sparse")):
        launches.update(train_run(DP8, expected, "dp", changes,
                                  run=run_dp)[0])
        dp_profile(changes, label)
    cfg = load_with(DP8, DP_SPARSE)
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
    G = load_with(DP8).data.batch_size
    slot = _data(load_with(DP8, DP_ONE), torch.device("cuda"),
                 Logger(quiet=True)).slot_nodes
    phase_fused_wide(((G, slot, [9, 128, 128, 128, 128, 10], True),),
                     dtypes=(torch.float32,), kinds=("none", "seed"),
                     tag="[dp] fused")
    return dict(launches)


def hybrid_launches(cfg, steps, evals):
    """fit_hybrid: the edge-partitioned counts (``ep_launches``), the GAT
    with JAX's one head."""
    if cfg.mpnn.conv_type.lower() == "gat":
        cfg = copy.deepcopy(cfg)
        cfg.mpnn.num_heads = 1
    return ep_launches(cfg, steps, evals)


def hybrid_setup(changes: dict, split: str, device, use_plan: bool):
    """(cfg, the hybrid block of ``split`` on a (1, 1) mesh with its
    info, the sharded model from seed 0) of the hybrid config."""
    import torch

    from graph_hscn_tpu_torch.data.pipeline import DataModule
    from graph_hscn_tpu_torch.parallel.hybrid import (build_hybrid_split,
                                                      hybrid_block)
    from graph_hscn_tpu_torch.parallel.mesh import make_mesh
    from graph_hscn_tpu_torch.parallel.sharded_gcn import build_sharded_model

    cfg = load_with(HYBRID, changes)
    dm = DataModule.from_config(cfg.data, pad_safety=cfg.runtime.pad_safety)
    t0 = time.perf_counter()
    plan, x, y, ok, meta = build_hybrid_split(dm.split(split), 1, 1,
                                              cfg.mesh.locality_reorder)
    conv = cfg.mpnn.conv_type.lower()
    blk = hybrid_block(plan, x, y, ok, make_mesh(("data", "model"), (1, 1),
                                                  device),
                       use_plan, graph_ids=conv == "gps")
    info = dict(rows=meta["node_mask"].shape[0], block_rows=meta[
        "block_size"], edges=int(plan["mask_loc"].sum()),
                halo_width=meta["halo_width"],
                seconds=time.perf_counter() - t0)
    dims = ([dm.num_features]
            + [cfg.mpnn.hidden_channels] * (cfg.mpnn.num_layers - 1)
            + [dm.num_classes])
    model = build_sharded_model(
        conv, dims, heads=cfg.mpnn.num_heads if conv == "gps" else 1,
        generator=torch.Generator().manual_seed(0),
        hidden=cfg.mpnn.hidden_channels)
    return cfg, blk, info, model.to(device)


def phase_hybrid_kernels() -> None:
    """csr_spmm (B1, F = 64, forward and transpose, the block's GCN
    weights) and spmm_mh / sddmm_mh (B6/B7 at the hybrid GAT's one head,
    C = 64) at the hybrid config's train block on a (1, 1) mesh, against
    their plain versions."""
    import torch

    from graph_hscn_tpu_torch.parallel.mesh import process_group
    with process_group(torch.device("cuda")) as device:
        _, blk, info, _ = hybrid_setup(HYBRID_ONE, "train", device, True)
        p = blk.csr
        print(f"[hybrid] train block: N_b={info['block_rows']} rows, "
              f"{p.num_edges} local edges ({p.col.numel()} slots), "
              f"H={info['halo_width']}, host plan {info['seconds']:.2f} s",
              flush=True)
        check_spmm_batch("hybrid block", p, blk.gcn_norm()[0],
                         [("forward", 64), ("transpose", 64)])
        for case in gat_cases(p, ((1, 64),), ((1, 64, torch.float32,
                                               torch.float32),)):
            if case["dtype"] == "float32":
                time_case("[hybrid]", case)


def hybrid_step_times(changes: dict, label: str, focus: dict) -> None:
    """[hybrid] The hybrid model's full-batch train step on the train block
    at a (1, 1) mesh (``loss_and_grads``, the all_reduce, AdamW),
    profiled and then timed steady (``ep_step_times``)."""
    import torch

    from graph_hscn_tpu_torch.parallel.mesh import process_group
    from graph_hscn_tpu_torch.parallel.sharded_gcn import loss_and_grads
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer
    with process_group(torch.device("cuda")) as device:
        cfg, blk, _, model = hybrid_setup(changes, "train", device, True)
        opt = build_optimizer(model.parameters(), cfg.optim.optim_type,
                              cfg.optim.lr, cfg.optim.weight_decay)

        def step(_):
            model.train()
            loss_and_grads(model, blk)
            opt.step()

        ep_step_times(f"hybrid {label}", step, focus, 6, 10)


def phase_hybrid_reference(changes: dict, label: str) -> None:
    """[reference] The hybrid model on the val split's block at a (1, 1)
    mesh, the card (the kernels) against the CPU (plain versions), the
    precision pinned to float32 and restored: logits within 1e-5 *
    max|ref|, loss and gradients 1e-4 * max|ref| (``card_against_cpu``,
    the activation decisions replayed: ``KinkPins``)."""
    import torch

    from graph_hscn_tpu_torch.parallel.mesh import process_group
    from graph_hscn_tpu_torch.runner import set_matmul_precision
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    set_matmul_precision("highest")
    try:
        outs, pins = {}, KinkPins()
        with process_group(torch.device("cuda")) as device:
            _, blk, info, model = hybrid_setup(changes, "val", device, True)
            outs["cuda"] = reference_outputs(model, blk, pins.record())
            state = {k: v.cpu() for k, v in model.state_dict().items()}
        with process_group(torch.device("cpu")) as device:
            _, blk, info, model = hybrid_setup(changes, "val", device,
                                               False)
            model.load_state_dict(state)
            outs["cpu"] = reference_outputs(model, blk, pins.replay())
        card_against_cpu(f"hybrid {label}", outs, pins, info,
                         [name for name, _ in model.named_parameters()])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def phase_hybrid() -> dict:
    """[hybrid] configs/GCN/voc_superpixels_GCN_hybrid.yaml at mesh.shape
    [1, 1] (512 graphs, hidden 64, 4 layers) through run_experiment,
    2 epochs, its snapshot scored by run_eval and main --eval --predict;
    its GAT twin (one head) and its GPS twin (64 graphs); launches
    counted (GCN 6 csr_spmm a train step, 3 an eval forward; GAT 6
    spmm_mh + 3 sddmm_mh, 3; GPS none); the GCN and GAT train steps
    profiled and timed steady; GCN and GAT card against CPU; B1 and B6/B7
    at the block.  Returns the runs' launches."""
    from collections import Counter
    launches = Counter()
    phase_hybrid_kernels()
    directory = SCRATCH / "hybrid"
    shutil.rmtree(directory, ignore_errors=True)
    saved = {**HYBRID_ONE, "training.checkpoint_dir": str(directory)}
    got, fit = train_run(HYBRID, hybrid_launches, "hybrid", saved)[:2]
    launches.update(got)
    for split, i in fit.partition.items():
        print(f"[hybrid] GCN {split}: N_b={i['block_rows']} rows, "
              f"E={i['edges']} real edges, H={i['halo_width']}, host plan "
              f"{i['seconds']:.3f} s", flush=True)
    launches.update(phase_eval(load_with(HYBRID, saved), fit.best_val_loss,
                               hybrid_launches, evals=2))
    phase_predict(HYBRID, directory, HYBRID_ONE)
    launches.update(train_run(HYBRID, hybrid_launches, "hybrid",
                              HYBRID_GAT)[0])
    launches.update(train_run(HYBRID, hybrid_launches, "hybrid",
                              HYBRID_GPS)[0])
    hybrid_step_times(HYBRID_ONE, "GCN", GCN_FOCUS)
    hybrid_step_times(HYBRID_GAT, "GAT", GAT_FOCUS)
    phase_hybrid_reference(HYBRID_ONE, "GCN")
    phase_hybrid_reference(HYBRID_GAT, "GAT")
    return dict(launches)


def jax_order_batches(dm, seed: int) -> list:
    """The train batches of the JAX package's PrefetchLoader for an epoch
    of ``seed``, by their definition: the split shuffled by
    ``default_rng(seed)``, cut into ``batch_size`` chunks, each packed
    with the single budget (a chunk over it split in halves)."""
    from graph_hscn_tpu_torch.data.batching import pack_batch

    def pack(chunk):
        try:
            return [pack_batch(chunk, dm.budget, slot_nodes=dm.slot_nodes,
                               with_spmm_plan=dm.with_spmm_plan)]
        except ValueError:
            mid = len(chunk) // 2
            return pack(chunk[:mid]) + pack(chunk[mid:])

    graphs = dm.split("train")
    idx = np.arange(len(graphs))
    np.random.default_rng(seed).shuffle(idx)
    return [b for i in range(0, len(idx), dm.batch_size)
            for b in pack([graphs[int(j)]
                           for j in idx[i:i + dm.batch_size]])]


def loader_epoch_profile(dm, cfg, label: str) -> None:
    """[loader] One train epoch of the host loop on ``dm.train_batches``
    (uploads on the main thread) under the profiler, after one unprofiled
    epoch: wall, device busy time and idle share a step."""
    import torch

    from graph_hscn_tpu_torch.runner import _model
    from graph_hscn_tpu_torch.train.loop import make_train_step
    from graph_hscn_tpu_torch.train.optimizers import build_optimizer
    from graph_hscn_tpu_torch.utils.logger import Logger
    model = _model(cfg, dm, torch.device("cuda"), None, Logger(quiet=True))
    opt = build_optimizer(model.parameters(), cfg.optim.optim_type,
                          cfg.optim.lr, cfg.optim.weight_decay)
    step, _ = make_train_step(model, opt, cfg.training.loss_fn,
                              node_level=True,
                              generator=torch.Generator(device="cuda"))
    count = []

    def epoch():
        count.clear()
        for b in dm.train_batches(epoch_seed=dm.seed):
            step(b.to("cuda"))
            count.append(1)

    epoch()
    torch.cuda.synchronize()
    dev, wall_ms = profiled(epoch, 1)
    report_profile(label, dev, wall_ms, len(count), "train steps (one "
                   "epoch, packing included)")


def phase_loader(workers0_median: float) -> dict:
    """[loader] configs/GCN/voc_superpixels_GCN_sparse.yaml with
    data.num_workers 2: two epochs' train batches equal, array for array
    (the CSR plans' too), to the JAX package's PrefetchLoader order
    (``jax_order_batches``); the host fit (run_experiment, 2 epochs) with
    its csr_spmm launches counted, its median step ms beside the
    num_workers 0 run's (``workers0_median``); an epoch of each profiled.
    Returns the run's launches."""
    import dataclasses

    import torch

    from graph_hscn_tpu_torch.runner import _data
    from graph_hscn_tpu_torch.utils.logger import Logger
    cfg = load_with(CONFIG, {"data.num_workers": 2})
    dm = _data(cfg, torch.device("cuda"), Logger(quiet=True))
    for seed in (dm.seed, dm.seed + 1):
        got = list(dm.train_batches(epoch_seed=seed))
        want = jax_order_batches(dm, seed)
        if len(got) != len(want):
            fail(f"[loader] {len(got)} batches, the JAX order {len(want)}")
        for a, b in zip(got, want):
            for f in dataclasses.fields(a):
                u, v = getattr(a, f.name), getattr(b, f.name)
                if f.name == "spmm":
                    same = all(np.array_equal(np.asarray(getattr(u, g.name)),
                                              np.asarray(getattr(v, g.name)))
                               for g in dataclasses.fields(u))
                else:
                    same = (u is None and v is None) or np.array_equal(u, v)
                if not same:
                    fail(f"[loader] epoch seed {seed}: field {f.name} "
                         "differs from the JAX order's")
        print(f"[loader] epoch seed {seed}: {len(got)} batches equal, array "
              "for array (CSR plans included), to the JAX PrefetchLoader "
              "order (node targets and a CSR plan: numpy packs, not the "
              "native batcher)", flush=True)
    launches, _, median, _ = train_run(CONFIG, voc_gcn_launches, "loader",
                                       {"data.num_workers": 2})
    print(f"[loader] median train step ms (synchronised host clock): "
          f"num_workers 2 {median:.3f}, num_workers 0 "
          f"{workers0_median:.3f} (the [train] run above)", flush=True)
    for workers in (0, 2):
        dm.num_workers = workers
        loader_epoch_profile(dm, cfg, f"[loader] VOC sparse GCN, "
                                      f"num_workers {workers}")
    return launches



def main() -> int:
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
    if sys.argv[1:2] == ["--kink-study"]:
        kink_study(int(sys.argv[2]))
        return 0
    kernels = (phase_kernels() + phase_fused_kernels(build_logs)
               + phase_gat_kernels() + phase_gatedgcn_kernels())
    phase_hbm()
    phase_hscn_kernels()
    phase_gin_kernels()
    t_ep = time.perf_counter()
    phase_edge_partition_kernels()
    t_ep = time.perf_counter() - t_ep
    # Each path's launches, counted from its own run alone.
    # The device-resident configs (capture_run) train captured, then
    # eagerly beside.
    launches, _, voc_median, _ = train_run(CONFIG, voc_gcn_launches)
    capture_run(PEPTIDES, no_launches)
    fused = capture_run(PEPTIDES_FUSED, fused_launches)
    gat = train_run(VOC_GAT, voc_gat_launches)[0]
    capture_run(PEPTIDES_GAT, no_launches)
    gated = train_run(VOC_GATED, voc_gatedgcn_launches)[0]
    capture_run(PEPTIDES_GATED, no_launches)
    capture_run(VOC_GCN, no_launches)
    for k in ("fused_gcn_fwd", "fused_gcn_bwd"):
        launches[k] = fused[k]
    for k in ("spmm_mh", "sddmm_mh"):
        launches[k] = gat[k]
    launches["segment_reduce"] = gated["segment_reduce"]
    hscn = train_run(VOC_HSCN, voc_hscn_launches)[0]
    for path in SHIPPED_HSCN:
        capture_run(path, no_launches)
    launches["csr_spmm"] += hscn["csr_spmm"]
    capture_run(GIN, no_launches)
    gin = train_run(GIN, gin_sparse_launches, changes=GIN_SPARSE)[0]
    launches["csr_spmm"] += gin["csr_spmm"]
    capture_run(GPS_FUNC, no_launches)
    capture_run(GPS_STRUCT, no_launches)
    capture_run(GPS_VOC, no_launches)
    capture_run(PEPTIDES_STRUCT_GCN, no_launches)
    phase_lr_schedule(GPS_STRUCT)
    phase_profile(CONFIG, "VOC sparse GCN", focus=GCN_FOCUS)
    phase_profile_peptides(PEPTIDES, "peptides unfused GCN")
    phase_profile_peptides(PEPTIDES_FUSED, "peptides fused GCN", fused=True)
    phase_profile(VOC_GAT, "VOC sparse GAT", focus=GAT_FOCUS)
    phase_profile_peptides(PEPTIDES_GAT, "peptides dense GAT")
    phase_profile(VOC_GATED, "VOC sparse GatedGCN")
    phase_profile_peptides(PEPTIDES_GATED, "peptides-struct GatedGCN")
    phase_profile_peptides(VOC_GCN, "VOC GCN, device dataset",
                           slotted=False)
    phase_profile_hscn(VOC_HSCN, "VOC sparse HSCN", focus=GCN_FOCUS)
    phase_profile_hscn(PEPTIDES_HSCN, "peptides HSCN")
    phase_profile_hscn(SHIPPED_HSCN[2], "peptides HSCN with feedback")
    phase_profile_peptides(GIN, "peptides GIN, device dataset")
    phase_profile(GIN, "peptides GIN, sparse batches", focus=GCN_FOCUS,
                  changes=GIN_SPARSE)
    phase_profile_peptides(GPS_FUNC, "peptides GPS, GCN local",
                           focus=GPS_FOCUS)
    phase_profile_peptides(GPS_STRUCT, "peptides-struct GPS, GatedGCN local",
                           focus=GPS_FOCUS)
    phase_profile_peptides(GPS_VOC, "VOC GPS, device dataset", slotted=False,
                           focus=GPS_FOCUS)
    phase_reference(CONFIG)
    phase_reference_fused()
    phase_reference(VOC_GAT)
    phase_reference(VOC_GATED)
    phase_reference(GIN, GIN_SPARSE)
    phase_reference_hscn()
    # Checkpoints, resume, eval-only mode and PE; the resumed and eval
    # runs' launches count with the main path's.
    phase_resume(PEPTIDES, no_launches, "peptides")
    voc, voc_fit, voc_cfg = phase_resume(CONFIG, voc_gcn_launches, "voc")
    phase_resume(GPS_STRUCT, no_launches, "gps_struct", check_lr=True)
    fused_dir = {"training.checkpoint_dir": str(SCRATCH / "fused")}
    shutil.rmtree(SCRATCH / "fused", ignore_errors=True)
    fused_fit, fused_res = train_run(PEPTIDES_FUSED, fused_launches,
                                     "eval", fused_dir)[:2]
    evals = (phase_eval(load_with(PEPTIDES_FUSED, fused_dir),
                        fused_res.best_val_loss, fused_launches),
             phase_eval(voc_cfg, voc_fit.best_val_loss, voc_gcn_launches))
    phase_predict(PEPTIDES_FUSED, SCRATCH / "fused")
    phase_cluster_routes(PEPTIDES_HSCN)
    phase_pe()
    t0 = time.perf_counter()
    ep = phase_edge_partition_runs()
    print(f"[time] the edge-partition phases: "
          f"{t_ep + time.perf_counter() - t0:.1f} s wall", flush=True)
    t0 = time.perf_counter()
    dp = phase_dp()
    print(f"[time] [dp]: {time.perf_counter() - t0:.1f} s wall", flush=True)
    t0 = time.perf_counter()
    hybrid = phase_hybrid()
    print(f"[time] [hybrid]: {time.perf_counter() - t0:.1f} s wall",
          flush=True)
    t0 = time.perf_counter()
    loader = phase_loader(voc_median)
    print(f"[time] [loader]: {time.perf_counter() - t0:.1f} s wall",
          flush=True)
    for counts in (voc, fused_fit, *evals, ep, dp, hybrid, loader):
        for kernel, n in counts.items():
            launches[kernel] += n
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(f"[time] chip_smoke.py: {time.perf_counter() - started:.1f} s wall "
          "from the first phase", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
