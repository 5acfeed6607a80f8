"""Dense-block view of a GraphBatch: the counterpart of
``graph_hscn_tpu/ops/dense.py``.

Only the dispatch is ported so far.  The slotted dense path (per-graph
``[G, slot, slot]`` adjacencies, batched matmuls) is slice 2 of the port.
"""

from __future__ import annotations

from graph_hscn_tpu_torch.data.structures import GraphBatch


def resolve_dense_adj(batch: GraphBatch):
    """None for a batch without slots (the sparse path).  A slotted batch
    needs the dense path, which is not ported yet."""
    if batch.slot is not None:
        raise NotImplementedError("dense slots: ROADMAP slice 2")
    return None
