"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W): the float32 rate outside the tensor cores, the dense bf16
tensor-core rate, and the HBM3 rate.  A share of a roofline is stated
against these, with the card's power limit beside it."""
from __future__ import annotations

from typing import Tuple

F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float,
                  peak_flops: float = F32_FLOPS) -> Tuple[float, str]:
    """(seconds, bound): the larger of operations over the peak rate and
    bytes over the memory rate, and which of the two it is."""
    t_ops = flops / peak_flops
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
