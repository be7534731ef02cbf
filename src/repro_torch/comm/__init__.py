"""Comm layer: the SPAC DSE over comm configurations (dse_comm, built on
repro_torch.core.dse), and the cross-pod gradient protocol
(``protocols.py``: ``wrap_grad_fn_with_pod_protocol``, ``compressed_mean``)
that the training step wraps its gradient function with."""
from .dse_comm import CommDSEProblem, CommSpec, autotune_moe, route_trace

__all__ = ["CommDSEProblem", "CommSpec", "autotune_moe", "route_trace"]
