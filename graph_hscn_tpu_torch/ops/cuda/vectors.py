"""What the gather kernels' launch plans share: vector widths, powers of
two, and the 16-byte alignment their vector loads need.

``spmm_kernel.csr_spmm_plan``, ``sddmm_kernel.edge_sddmm_plan`` and
``multihead_kernel.multihead_plan`` lay a gathered row over a group of
lanes as vectors of up to 16 bytes; the helpers here are theirs, and
:class:`RowPlan` is the plan of the first two.
"""

from __future__ import annotations

import dataclasses

import torch

def pow2_ceil(v: int) -> int:
    """The least power of two >= v (1 for v <= 1)."""
    return 1 << max(0, v - 1).bit_length()


def widest(n: int, esize: int, most: int | None = None) -> int:
    """The values in the widest vector of 16, 8, 4 or 2 bytes (at least one
    value) whose values divide ``n`` and number at most ``most``."""
    return next(v for v in (16 // esize, 8 // esize, 4 // esize, 2 // esize,
                            1)
                if v >= 1 and n % v == 0 and (most is None or v <= most))


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data is not 16-byte aligned (a view
    that starts inside its storage): the kernels load 16-byte vectors."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """How ``csr_spmm`` or ``edge_sddmm`` lays a gathered row of ``f``
    values over its threads: a group of ``lanes`` (L) lanes a row (an output
    row of csr_spmm, an edge of edge_sddmm), 32 / L of them a warp, each
    lane ``passes`` (VP) vectors of ``vec`` (V) consecutive values at once.
    Vector j of the row is read by lane ``j % L`` of the group as its
    vector ``(j // L) % VP`` in chunk ``j // (L * VP)``: a pass of the group
    reads L consecutive vectors.  ``batch`` (B): csr_spmm's edges whose
    loads are in flight before the first add (1 for edge_sddmm)."""

    f: int
    vec: int        # V
    passes: int     # VP
    lanes: int      # L: a power of two of at most 32
    batch: int = 1  # B

    @property
    def chunks(self) -> int:
        return -(-(self.f // self.vec) // (self.lanes * self.passes))

    def label(self) -> str:
        return (f"V={self.vec} VP={self.passes} L={self.lanes} "
                f"B={self.batch}")
