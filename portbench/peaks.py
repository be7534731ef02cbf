"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

#: bf16 / fp16 on the tensor cores, FLOP/s
BF16_FLOPS = 989.4e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES = 3.35e12


def least_seconds(flop: float, moved: float) -> float:
    """The least time the card could take for ``flop`` bf16 operations and
    ``moved`` bytes of device memory traffic."""
    return max(flop / BF16_FLOPS, moved / HBM_BYTES)
