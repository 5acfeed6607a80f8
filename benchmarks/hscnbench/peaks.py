"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit): float32 outside the tensor cores, and HBM3
bandwidth.  The copy of ``chip_smoke.py``'s (:317-318)."""

PEAK_FLOPS_F32 = 67e12
PEAK_BYTES_S = 3.35e12


def least_time(nbytes: float, ops: float) -> float:
    """The least seconds the chip could take: the larger of the bytes over
    the bandwidth and the operations over the float32 peak."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_FLOPS_F32)
