"""Workload traces (paper SS V-A) + the Trace datatype.

Capture ingestion (``repro.traces.ingest``) is not ported yet."""
from .base import Trace, merge
from .workloads import WORKLOADS, datacenter, hft, industry, rl_allreduce, underwater, uniform

__all__ = ["Trace", "WORKLOADS", "datacenter", "hft", "industry", "merge",
           "rl_allreduce", "underwater", "uniform"]
