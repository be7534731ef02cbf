"""What the per-layer readers share: the reading they are given, the
classes of device operations by kernel name, and the roofline share."""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

from portbench.peaks import least_seconds

__all__ = ["Reading", "FLASH_FWD", "FLASH_BWD", "SSD_FWD", "SSD_BWD", "PORT", "GEMM",
           "group", "roofline_pct"]

#: the port's hand-written kernels (``src/repro_torch/csrc``), by launch
FLASH_FWD = re.compile(r"\bflash_(fwd|wgmma)\b")
FLASH_BWD = re.compile(r"\bbwd_(pre|kv|q)(_wgmma)?\b")
SSD_FWD = re.compile(r"\bssd_(split_bc|chunk_vec|wgmma)\b")
SSD_BWD = re.compile(r"\bssd_bwd_\w+")
PORT = (FLASH_FWD, FLASH_BWD, SSD_FWD, SSD_BWD)
#: the matrix products of cuBLAS / cuBLASLt (and their split-K reductions)
GEMM = re.compile(r"nvjet|gemm|gemv|cutlass|xmma|cublas|splitk", re.IGNORECASE)


@dataclasses.dataclass
class Reading:
    """What a traced run gives a reader: the kernels of the window (name ->
    (summed seconds, launches)), the steps completed in it, its length on
    the host's clock, the device's busy seconds in the traced window, the
    configuration's ``model`` block and the traffic's parameters."""

    kernels: Dict[str, Tuple[float, int]]
    steps: int
    window_s: float
    busy_s: float
    trace_window_s: float
    model: Dict
    traffic: Dict


def group(r: Reading, pattern) -> Tuple[float, int]:
    """(seconds, calls) of the kernels whose names match ``pattern``; one
    call launches each of them once, so the calls are the most launches of
    any one of them."""
    sec, calls = 0.0, 0
    for name, (s, n) in r.kernels.items():
        if pattern.search(name):
            sec += s
            calls = max(calls, n)
    return sec, calls


def roofline_pct(r: Reading, pattern, flop: float, moved: float) -> Optional[float]:
    """The least time of the calls (``flop`` and ``moved`` bytes each) over
    the time the kernels took, in %; None where no such kernel ran."""
    sec, calls = group(r, pattern)
    if not calls or sec <= 0:
        return None
    return 100.0 * calls * least_seconds(flop, moved) / sec
