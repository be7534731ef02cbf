"""Workload traces (paper SS V-A) + the Trace datatype + capture ingestion."""
from .base import Trace, merge
from .ingest import (IngestError, Pipeline, STAGES, Stage, ingest, read_csv,
                     read_pcap, write_pcap)
from .workloads import WORKLOADS, datacenter, hft, industry, rl_allreduce, underwater, uniform

__all__ = ["IngestError", "Pipeline", "STAGES", "Stage", "Trace", "WORKLOADS",
           "datacenter", "hft", "industry", "ingest", "merge", "read_csv",
           "read_pcap", "rl_allreduce", "underwater", "uniform", "write_pcap"]
