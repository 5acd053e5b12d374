"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit). A card set below 700 W runs slower under load, so
every traced run reports the card's limit beside its shares."""

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12          # tensor cores
FP32_OPS_PER_S = 67e12            # CUDA cores; also the rate of int compares


def roofline_s(ops: float, ops_per_s: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over their peak and the bytes over the memory's."""
    return max(ops / ops_per_s, n_bytes / HBM_BYTES_PER_S)
