"""Prefetching batch loader: packing on a worker thread, with the native
C++ batcher where it applies: the counterpart of
``graph_hscn_tpu/data/loader.py``.

The host's packing (flatten, counting sort, padding) is the data
pipeline's CPU cost; this loader overlaps it with the device's step by
packing numpy batches ahead, ``prefetch`` deep, on one worker thread (the
reference DataLoader's ``num_workers``, loader.py:57-58).  The native
packer runs without the GIL, so one thread overlaps for real.  The worker
makes no CUDA call: the train loop uploads each batch on the main thread.

The batches are JAX's ``PrefetchLoader``'s: the same shuffle
(``default_rng(epoch_seed).shuffle``), ``batch_size`` chunks, the same
rule for the native path, and a chunk that overflows the budget split in
halves, recursively.  This order may differ from the inline
``iter_batches``, which closes a batch early where the next graph would
overflow.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np

from graph_hscn_tpu_torch.data import native
from graph_hscn_tpu_torch.data.batching import GraphData, PadBudget, pack_batch
from graph_hscn_tpu_torch.data.structures import GraphBatch


class PrefetchLoader:
    """Iterable over packed batches with background packing.  Packs with
    numpy where the native library is missing or does not apply (a CSR
    plan, edge features, clusters, PE, node-level targets); the
    prefetching applies either way."""

    def __init__(self, graphs: Sequence[GraphData], batch_size: int,
                 budget: PadBudget, shuffle: bool = False,
                 seed: int = 0, slot_nodes: int | None = None,
                 with_spmm_plan: bool = False, prefetch: int = 2):
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.budget = budget
        self.shuffle = shuffle
        self.seed = seed
        self.slot_nodes = slot_nodes
        self.with_spmm_plan = with_spmm_plan
        self.prefetch = max(prefetch, 1)
        self.use_native = bool(native.native_available()
                               and not with_spmm_plan
                               and self.graphs
                               and self.graphs[0].y is not None
                               and self.graphs[0].edge_attr is None
                               and self.graphs[0].cluster is None
                               and self.graphs[0].eigvecs is None)

    def _chunks(self, epoch_seed: int):
        idx = np.arange(len(self.graphs))
        if self.shuffle:
            np.random.default_rng(epoch_seed).shuffle(idx)
        for start in range(0, len(idx), self.batch_size):
            yield [self.graphs[int(i)]
                   for i in idx[start:start + self.batch_size]]

    def _pack_multi(self, chunk) -> list[GraphBatch]:
        """Pack one chunk; on a budget overflow, split it recursively."""
        try:
            if self.use_native:
                b = native.pack_batch_native(chunk, self.budget,
                                             slot_nodes=self.slot_nodes)
            else:
                b = pack_batch(chunk, self.budget,
                               slot_nodes=self.slot_nodes,
                               with_spmm_plan=self.with_spmm_plan)
            return [b]
        except ValueError:
            if len(chunk) == 1:
                raise
            mid = len(chunk) // 2
            return (self._pack_multi(chunk[:mid])
                    + self._pack_multi(chunk[mid:]))

    def epoch(self, epoch_seed: int | None = None) -> Iterator[GraphBatch]:
        """One epoch's batches, packed ahead on a worker thread; a
        packing error is raised here, in the consumer."""
        seed = self.seed if epoch_seed is None else epoch_seed
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        failed = []

        def worker():
            try:
                for chunk in self._chunks(seed):
                    for b in self._pack_multi(chunk):
                        q.put(b)
            except BaseException as e:
                failed.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is done:
                break
            yield item
        t.join()
        if failed:
            raise failed[0]

    def __iter__(self):
        return self.epoch()
