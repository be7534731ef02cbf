from .ops import RING_BUDGET_BYTES, ring_rows_per_chunk, ring_scan
from .ref import ring_scan_ref

__all__ = ["RING_BUDGET_BYTES", "ring_rows_per_chunk", "ring_scan",
           "ring_scan_ref"]
