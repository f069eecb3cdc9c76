"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, at the full 700 W power limit): float32 outside the tensor cores and
HBM3 bandwidth.  A kernel's bound is the larger of its operations over the
one and its bytes over the other."""

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(n_flops: float, n_bytes: float) -> tuple[float, str]:
    """The least time the card could take, in seconds, and what binds it
    (``"flops"`` or ``"bytes"``)."""
    t_ops, t_bytes = n_flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES_PER_S
    return (t_ops, "flops") if t_ops >= t_bytes else (t_bytes, "bytes")
