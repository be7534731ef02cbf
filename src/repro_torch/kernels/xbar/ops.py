"""Public batched crossbar-contention op.

Dispatch policy, as in the JAX package: float64 inputs take the
absolute-time scan (bit-identical to the serial surrogate's recurrence; it
returns *absolute* departure times so ulp-exact occupancy comparisons hold
downstream); float32 inputs take the slack-form scan, whose carries never
hold absolute timestamps, so precision survives long traces.  The float32
path returns departure *offsets* (dep - arrival).

Device policy: tensors on a CUDA device launch the hand-written kernel
(``kernel.xbar_scan``); tensors on the CPU take the plain PyTorch version
(``ref.py``).  There is no fallback from one to the other."""

from __future__ import annotations

import torch

from . import kernel
from .ref import xbar_contend_abs_ref, xbar_contend_slack_ref

__all__ = ["xbar_contend"]


def xbar_contend(t, dt, src, dst, svc, *, n_ports: int, absolute: bool = None):
    """t/dt/src/dst [m] shared trace, svc [B, m] -> [B, m] departure times
    (absolute on the float64 path, arrival-relative offsets on float32).

    All tensors lie on ``svc``'s device.  Pass ``absolute=True`` to
    *require* absolute-time semantics; it raises on a float32 ``svc``."""
    is_f64 = svc.dtype == torch.float64
    if absolute is None:
        absolute = is_f64
    elif absolute != is_f64:
        raise ValueError(
            "absolute departure times need the float64 scan and the slack "
            f"form needs float32; got absolute={absolute} with {svc.dtype}")
    if svc.device.type == "cpu":
        if absolute:
            return xbar_contend_abs_ref(t, src, dst, svc, n_ports=n_ports)
        return xbar_contend_slack_ref(dt, src, dst, svc, n_ports=n_ports)
    return kernel.xbar_scan(
        (t if absolute else dt).contiguous(), src.to(torch.int32).contiguous(),
        dst.to(torch.int32).contiguous(), svc.t().contiguous(),
        n_ports=n_ports, absolute=absolute)
