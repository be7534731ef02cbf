"""Comm layer: the SPAC DSE over comm configurations (dse_comm, built on
repro_torch.core.dse).  The pod gradient protocol (``protocols.py`` in the
JAX package) comes with the multi-pod training path (ROADMAP)."""
from .dse_comm import CommDSEProblem, CommSpec, autotune_moe, route_trace

__all__ = ["CommDSEProblem", "CommSpec", "autotune_moe", "route_trace"]
