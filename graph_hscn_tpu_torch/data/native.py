"""ctypes bindings of the native C++ batcher (native/batcher.cpp): the
counterpart of ``graph_hscn_tpu/data/native.py``.

The shared library ``native/libgraphbatch.so`` is in the repository; it is
built with ``make -C native`` only where it is missing (g++, no pybind11:
hence the C ABI and ctypes).  ``native_available()`` gates every call
site, and the numpy packer (data/batching.py) stays the reference: the
tests hold the two equal.  ctypes releases the GIL for the call, so a
worker thread packing with it overlaps the main thread (data/loader.py).

JAX's ``spmm_windows_native`` is not ported: it scans the TPU kernel's
windowed one-hot plan, which the port's CSR plans replace.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

from graph_hscn_tpu_torch.data.structures import GraphBatch

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libgraphbatch.so"
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True, timeout=120)
        return _LIB_PATH.exists()
    except Exception:
        return False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists() and not _build():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.pack_batch.restype = ctypes.c_int
    lib.pack_batch.argtypes = [
        ctypes.c_int32, i64p, i64p, f32p, ctypes.c_int32, i32p, i32p,
        f32p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        f32p, i32p, i32p, i32p, i32p, i32p, u8p, u8p, u8p, f32p, f32p,
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _ptr(arr, ctype):
    return (arr.ctypes.data_as(ctypes.POINTER(ctype)) if arr is not None
            else None)


def pack_batch_native(graphs, budget, slot_nodes: int | None = None,
                      materialize_dense: bool = False) -> GraphBatch | None:
    """The native ``batching.pack_batch`` (graph-level ``y`` only, no edge
    features, no plan): a GraphBatch, or None without the library.
    ``materialize_dense`` fills the slotted batch's dense adjacency on the
    host (otherwise the model builds it on the device,
    ``ops/dense.py``).  A budget violation raises ``ValueError``."""
    lib = _load()
    if lib is None:
        return None
    G = len(graphs)
    F = graphs[0].x.shape[1]
    node_offsets = np.zeros(G + 1, np.int64)
    edge_offsets = np.zeros(G + 1, np.int64)
    for i, g in enumerate(graphs):
        node_offsets[i + 1] = node_offsets[i] + g.num_nodes
        edge_offsets[i + 1] = edge_offsets[i] + g.num_edges
    node_feat = np.ascontiguousarray(
        np.concatenate([g.x for g in graphs]).astype(np.float32))
    edge_src = np.ascontiguousarray(np.concatenate(
        [g.edge_index[0] for g in graphs]).astype(np.int32))
    edge_dst = np.ascontiguousarray(np.concatenate(
        [g.edge_index[1] for g in graphs]).astype(np.int32))
    has_y = graphs[0].y is not None
    C = int(np.asarray(graphs[0].y).reshape(-1).shape[0]) if has_y else 0
    y = (np.ascontiguousarray(np.stack(
        [np.asarray(g.y, np.float32).reshape(-1) for g in graphs]))
        if has_y else None)

    GP = budget.num_graphs
    E = budget.num_edges
    slot = slot_nodes or 0
    N = (GP - 1) * slot if slot else budget.num_nodes

    out_node_feat = np.empty((N, F), np.float32)
    out_senders = np.empty(E, np.int32)
    out_receivers = np.empty(E, np.int32)
    out_node_graph = np.empty(N, np.int32)
    out_n_node = np.empty(GP, np.int32)
    out_n_edge = np.empty(GP, np.int32)
    out_node_mask = np.empty(N, np.uint8)
    out_edge_mask = np.empty(E, np.uint8)
    out_graph_mask = np.empty(GP, np.uint8)
    out_y = np.empty((GP, C), np.float32) if has_y else None
    out_dense = (np.empty((GP - 1, slot, slot), np.float32)
                 if (slot and materialize_dense) else None)

    rc = lib.pack_batch(
        G, _ptr(node_offsets, ctypes.c_int64),
        _ptr(edge_offsets, ctypes.c_int64),
        _ptr(node_feat, ctypes.c_float), F,
        _ptr(edge_src, ctypes.c_int32), _ptr(edge_dst, ctypes.c_int32),
        _ptr(y, ctypes.c_float), C,
        budget.num_nodes, E, GP, slot,
        _ptr(out_node_feat, ctypes.c_float),
        _ptr(out_senders, ctypes.c_int32),
        _ptr(out_receivers, ctypes.c_int32),
        _ptr(out_node_graph, ctypes.c_int32),
        _ptr(out_n_node, ctypes.c_int32),
        _ptr(out_n_edge, ctypes.c_int32),
        _ptr(out_node_mask, ctypes.c_uint8),
        _ptr(out_edge_mask, ctypes.c_uint8),
        _ptr(out_graph_mask, ctypes.c_uint8),
        _ptr(out_y, ctypes.c_float),
        _ptr(out_dense, ctypes.c_float),
    )
    if rc != 0:
        raise ValueError(f"native pack_batch failed with code {rc}")
    return GraphBatch(
        node_feat=out_node_feat, senders=out_senders,
        receivers=out_receivers, node_graph=out_node_graph,
        n_node=out_n_node, n_edge=out_n_edge,
        node_mask=out_node_mask.astype(bool),
        edge_mask=out_edge_mask.astype(bool),
        graph_mask=out_graph_mask.astype(bool),
        y=out_y, dense_adj=out_dense, slot=slot_nodes,
    )
