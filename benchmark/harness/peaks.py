"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit): HBM bytes/s and float32 operations/s outside the tensor cores."""

PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: bytes over the HBM rate or
    operations over the f32 rate, whichever is larger."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_OPS_S)
