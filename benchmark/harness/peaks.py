"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): float32 outside the tensor cores and HBM3
bandwidth.  A roofline share is stated against these, with the card's
power limit printed beside it."""

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_seconds(byts: float, flops: float) -> float:
    """The least time the chip could take: the larger of the bytes over
    the bandwidth and the operations over the float32 rate."""
    return max(byts / HBM_BYTES_PER_S, flops / F32_FLOPS)
