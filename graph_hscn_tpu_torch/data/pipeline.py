"""Dataset pipeline: config -> ragged graphs -> split -> padded batches.

The counterpart of ``graph_hscn_tpu/data/pipeline.py`` (the reference's
loader.py:63-108, load_dataset + get_loader).  Data source resolution order:
  1. cached real LRGB arrays under ``data_cfg.data_dir`` (data/lrgb.py);
  2. deterministic synthetic generator (data/synthetic.py).

Batches are numpy ``GraphBatch``es; the train loop moves each to the device.
With ``data.num_workers > 0`` the train batches are packed ahead on a
worker thread (data/loader.py).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Iterator

import numpy as np

from graph_hscn_tpu_torch.data import synthetic
from graph_hscn_tpu_torch.data.batching import (GraphData, PadBudget,
                                                bucketed_budgets,
                                                iter_batches, pack_batch)
from graph_hscn_tpu_torch.data.loader import PrefetchLoader
from graph_hscn_tpu_torch.data.structures import GraphBatch

_SYNTH = {
    "peptides_func": synthetic.make_peptides_func,
    "peptides_struct": synthetic.make_peptides_struct,
    "voc_superpixels": synthetic.make_voc_superpixels,
}


@dataclasses.dataclass
class DataModule:
    graphs: list[GraphData]
    split_idx: dict[str, np.ndarray]
    budget: PadBudget
    batch_size: int
    num_features: int
    num_classes: int
    task_level: str
    seed: int = 0
    slot_nodes: int | None = None   # slotted dense packing (runner sets it)
    with_spmm_plan: bool = False    # attach the SpMM kernel's CSR plans
    budgets: tuple[PadBudget, ...] | None = None  # shape buckets (ascending)
    num_workers: int = 0

    @classmethod
    def from_config(cls, data_cfg, pad_safety: float = 1.15) -> "DataModule":
        graphs = None
        if data_cfg.data_dir is not None:
            from graph_hscn_tpu_torch.data import lrgb
            graphs, split_idx = lrgb.try_load(data_cfg.data_dir,
                                              data_cfg.dataset_name)
            if graphs is None:
                # An explicit data_dir is a request for REAL data: falling
                # back to the synthetic generator would silently train on
                # the wrong dataset.
                raise FileNotFoundError(
                    f"data_dir={data_cfg.data_dir!r} has no usable "
                    f"{data_cfg.dataset_name}.npz cache (run "
                    "scripts/convert_lrgb.py); refusing to fall back to "
                    "synthetic data silently — unset data_dir for the "
                    "synthetic generator")
        if graphs is None:
            maker = _SYNTH.get(data_cfg.dataset_name)
            if maker is None:
                raise ValueError(
                    f"Unknown or unsupported dataset: {data_cfg.dataset_name}")
            graphs = maker(num_graphs=data_cfg.num_graphs,
                           seed=data_cfg.seed)
            split_idx = synthetic.split_indices(len(graphs),
                                                seed=data_cfg.seed + 42)
        budgets = bucketed_budgets(graphs, data_cfg.batch_size,
                                   num_buckets=data_cfg.num_buckets,
                                   safety=pad_safety)
        g0 = graphs[0]
        if data_cfg.task_level == "graph":
            num_classes = int(np.asarray(g0.y).reshape(-1).shape[0])
        else:
            num_classes = g0.node_y.shape[1]
        return cls(graphs=graphs, split_idx=split_idx, budget=budgets[-1],
                   batch_size=data_cfg.batch_size,
                   num_features=g0.x.shape[1], num_classes=num_classes,
                   task_level=data_cfg.task_level, seed=data_cfg.seed,
                   num_workers=data_cfg.num_workers, budgets=budgets)

    def split(self, name: str) -> list[GraphData]:
        return [self.graphs[int(i)] for i in self.split_idx[name]]

    def train_batches(self, epoch_seed: int | None = None
                      ) -> Iterator[GraphBatch]:
        seed = self.seed if epoch_seed is None else epoch_seed
        if self.num_workers > 0 and len(self._budgets()) > 1:
            # Background packing is single-budget; the JAX package falls
            # back to the inline path here too.
            warnings.warn("num_workers > 0 is ignored with num_buckets > 1"
                          " (background packing is single-budget); using"
                          " inline bucketed packing.", stacklevel=2)
        elif self.num_workers > 0:
            # The reference DataLoader's num_workers (loader.py:57-58):
            # packing ahead on a worker thread, the native batcher where
            # it applies.
            loader = PrefetchLoader(
                self.split("train"), self.batch_size, self.budget,
                shuffle=True, seed=seed, slot_nodes=self.slot_nodes,
                with_spmm_plan=self.with_spmm_plan)
            return loader.epoch(seed)
        rng = np.random.default_rng(seed)
        return iter_batches(self.split("train"), self.batch_size,
                            self._budgets(), shuffle=True, rng=rng,
                            slot_nodes=self.slot_nodes,
                            with_spmm_plan=self.with_spmm_plan)

    def eval_batches(self, name: str) -> list[GraphBatch]:
        return list(iter_batches(self.split(name), self.batch_size,
                                 self._budgets(), shuffle=False,
                                 slot_nodes=self.slot_nodes,
                                 with_spmm_plan=self.with_spmm_plan))

    def _budgets(self) -> tuple[PadBudget, ...]:
        # Slotted dense packing fixes N to (G-1)*slot — bucketing by node
        # budget would be a no-op there, so fall back to the single budget.
        if self.budgets is None or self.slot_nodes is not None:
            return (self.budget,)
        return self.budgets

    def example_batch(self) -> GraphBatch:
        """The first ``batch_size`` training graphs, packed as a batch."""
        gs = self.split("train")[: self.batch_size]
        return pack_batch(gs, self.budget, slot_nodes=self.slot_nodes,
                          with_spmm_plan=self.with_spmm_plan)

    def apply_transform(self, fn: Callable[[GraphData], GraphData]
                        ) -> None:
        """A per-graph transform in place: the analog of the reference's
        pre_transform_in_memory (transform/pre_transform.py:7-25)."""
        self.graphs = [fn(g) for g in self.graphs]

    def enable_dense_slots(self, multiple: int = 8,
                           max_slot: int = 512) -> bool:
        """Turn on slotted dense packing if every graph fits a slot."""
        slot = ((self.max_nodes_per_graph() + multiple - 1)
                // multiple) * multiple
        if slot > max_slot:
            return False
        self.slot_nodes = slot
        return True

    @property
    def num_edge_features(self) -> int | None:
        """The width of the graphs' edge features, or None without them."""
        attr = self.graphs[0].edge_attr
        return None if attr is None else int(attr.shape[1])

    def max_nodes_per_graph(self) -> int:
        return max(g.num_nodes for g in self.graphs)
