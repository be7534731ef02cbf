"""Fault tolerance: supervisor (restart), straggler watch, elastic re-mesh."""
from .elastic import remesh, scaled_microbatches, shardings_for
from .supervisor import (FaultInjector, NodeFailure, RunResult, StragglerWatch,
                         Supervisor)
__all__ = ["FaultInjector", "NodeFailure", "RunResult", "StragglerWatch",
           "Supervisor", "remesh", "scaled_microbatches", "shardings_for"]
