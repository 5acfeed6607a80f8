"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/<name>-<hash>.so``
under the project root, then loaded with ``ctypes``.  The hash covers the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
kernel is rebuilt and an unchanged one is loaded from the previous build.  Nothing is built when a module is imported:
the first launch builds what it needs, and :func:`build_all` builds every
kernel at once, one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from graph_hscn_tpu_torch.constants import PROJECT_DIR

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = PROJECT_DIR / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U32 = ctypes.c_uint32
_PP = ctypes.POINTER(ctypes.c_void_p)   # a host array of device pointers
_IP = ctypes.POINTER(ctypes.c_int)      # a host array of ints
# The C signature of each kernel's entry point: (argument types); every
# entry point returns cudaGetLastError() as an int.
SIGNATURES = {
    # row_ptr, col, order (or null), w, x, x_bf16, out, n_rows, f, the plan
    # (vec, passes, lanes, batch), stream
    "csr_spmm": (_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P),
    # row, col, h_src, src_bf16, h_dst, dst_bf16, out, n_edges, n_real, f,
    # the plan (vec, passes, lanes), stream
    "edge_sddmm": (_P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P),
    # row_ptr, col, order (or null), alpha, x, x_bf16, out, n_rows, heads,
    # c, the plan (vec, passes, lanes_per_head, lanes, row_layout, batch),
    # stream
    "spmm_mh": (_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                _I, _P),
    # row, col, h_src, src_bf16, h_dst, dst_bf16, out, n_edges, n_real,
    # heads, c, the plan (vec, passes), stream
    "sddmm_mh": (_P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P),
    # row_ptr, order (or null), msgs, msgs_bf16, out, n_rows, f, stream
    "segment_reduce": (_P, _P, _P, _I, _P, _I, _I, _P),
    # a_hat, x, bf16, w[], b[], bits[], out[], dims[], num_layers, graphs,
    # slot, mode, thr, scale, seed, the plan (cluster, rows, jt, fc,
    # resident), stream
    "fused_gcn_fwd": (_P, _P, _I, _PP, _PP, _PP, _PP, _IP, _I, _I, _I, _I,
                      _U32, _F, _P, _I, _I, _I, _I, _I, _P),
    # a_hat, x, bf16, w[], act[], g, dx, partial, grads, dims[], num_layers,
    # graphs, slot, keep_scale, the plan (as above), stream
    "fused_gcn_bwd": (_P, _P, _I, _PP, _PP, _P, _P, _P, _P, _IP, _I, _I, _I,
                      _F, _I, _I, _I, _I, _I, _P),
}
# Further entry points of a kernel's library: {library: {function: (argument
# types)}}, each returning an int.
EXTRA_FUNCTIONS = {
    # bf16, cluster, smem -> cudaOccupancyMaxActiveClusters, or -error
    "fused_gcn_fwd": {"fused_gcn_fwd_max_clusters": (_I, _I, _I)},
    "fused_gcn_bwd": {"fused_gcn_bwd_max_clusters": (_I, _I, _I)},
}

_LOADED: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float       # 0.0 when an earlier build was reused
    log: str             # nvcc's output (ptxas -v: registers, spills)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names=tuple(SIGNATURES)) -> list[BuildResult]:
    """Compile every kernel that has no current build, one nvcc process
    per source, all running at once.  Raises with nvcc's output if any
    compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = []
    results = []
    for name in names:
        out = library_path(name)
        if out.exists():
            results.append(BuildResult(name, out, 0.0, ""))
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending.append((name, out, tmp, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, proc, t0 in pending:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent build never sees half
        results.append(BuildResult(name, out, seconds, log))
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def check_cuda_tensors(name: str, *tensors) -> None:
    """Raise unless every tensor is contiguous and on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel runs on CUDA "
                         "and its plain version on the CPU")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed, with its
    argument and return types declared."""
    lib = _LOADED.get(name)
    if lib is None:
        (result,) = build_all((name,))
        lib = ctypes.CDLL(str(result.path))
        for fname, argtypes in {name: SIGNATURES[name],
                                **EXTRA_FUNCTIONS.get(name, {})}.items():
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
