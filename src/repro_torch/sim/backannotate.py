"""Hardware back-annotation (§IV-A.1).

The paper injects performance metrics from physical FPGA runs into the
simulators.  Our "physical hardware" is the cycle-level switch
(``repro_torch.switch``): ``annotate(..., source="cycle_sim")`` runs a short
saturation trace through it and measures the achieved scheduler efficiency η
(matching quality) per (scheduler, ports, VOQ) family, caching the result.
``source="model"`` uses the analytic defaults instead (fast functional mode) —
the user-facing accuracy/speed toggle the paper describes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.archspec import SchedulerKind, SwitchArch, ForwardTableKind
from repro_torch.core.binding import BoundProtocol
from .resources import ResourceReport, synthesize

__all__ = ["HardwareParams", "annotate", "analytic_eta"]


@dataclasses.dataclass(frozen=True)
class HardwareParams:
    fclk_hz: float
    pipeline_cycles: int
    eta: float                 # scheduler/matching efficiency in (0, 1]
    arb_cycles: float          # mean extra arbitration wait per packet
    ingress_stall_cycles: float  # e.g. MultiBankHash conflict stalls
    report: ResourceReport


def analytic_eta(arch: SwitchArch, i_burst: float = 1.0) -> float:
    n = arch.n_ports
    if arch.sched is SchedulerKind.ISLIP:
        eta = min(0.96 + 0.02 * (arch.islip_iters - 2), 0.99)
        eta -= 0.05 * min(i_burst / 20.0, 1.0)   # per-cycle re-arbitration under bursts
    elif arch.sched is SchedulerKind.RR:
        eta = 0.80 + 0.6 / n
    else:  # EDRRM: exhaustive service amortises arbitration over bursts
        eta = 0.86 + min(0.012 * i_burst, 0.12)
    return float(min(max(eta, 0.5), 0.995))


def _arb_cycles(arch: SwitchArch, i_burst: float) -> float:
    n = arch.n_ports
    if arch.sched is SchedulerKind.RR:
        return 0.35 * n
    if arch.sched is SchedulerKind.ISLIP:
        return arch.islip_iters + 1.0
    return 2.0 + 0.25 * n / max(i_burst, 1.0)


_ETA_CACHE: Dict[Tuple, float] = {}


def _measured_eta(arch: SwitchArch, bound: BoundProtocol, fclk_hz: float,
                  device=None) -> float:
    """Run a short saturation trace through the cycle-level switch; measure the
    achieved output utilisation = matching efficiency.  The cache is keyed by
    family only, so the first caller's architecture and protocol set a
    family's η for the process, as in the reference, custom-kernel hooks
    included (on a card they run between the switch loop's ingress and
    egress passes); ``device`` is where the switch runs (default: the first
    CUDA device) and does not change η."""
    key = (arch.sched, arch.n_ports, arch.voq, arch.islip_iters)
    if key in _ETA_CACHE:
        return _ETA_CACHE[key]
    import numpy as np
    from repro_torch.traces.base import Trace
    from repro_torch.switch.switch import simulate

    rng = np.random.default_rng(0)
    n = arch.n_ports
    # saturated single-flit uniform traffic: every port offers a packet per cycle
    cycles = 1200
    payload = max(1, arch.bus_bits // 8 - bound.header_bytes)
    per_cycle = 1.0 / fclk_hz
    times, srcs, dsts = [], [], []
    for s in range(n):
        t = np.arange(cycles) * per_cycle
        times.append(t)
        srcs.append(np.full(cycles, s))
        d = rng.integers(0, n - 1, size=cycles)
        dsts.append(np.where(d >= s, d + 1, d))
    tr = Trace("calib", np.concatenate(times), np.concatenate(srcs),
               np.concatenate(dsts), np.full(n * cycles, payload), n)
    res = simulate(arch, bound, tr, fclk_hz=fclk_hz, max_cycles=cycles + 256,
                   device=device)
    eta = res.delivered_copies / float(n * cycles)
    eta = float(min(max(eta, 0.4), 1.0))
    _ETA_CACHE[key] = eta
    return eta


def annotate(
    arch: SwitchArch,
    bound: Optional[BoundProtocol] = None,
    *,
    source: str = "model",
    i_burst: float = 1.0,
    device=None,
) -> HardwareParams:
    """``device`` is where ``source="cycle_sim"`` runs the cycle-level switch
    (default: the first CUDA device)."""
    rep = synthesize(arch, bound)
    fclk = rep.fmax_mhz * 1e6
    if source == "cycle_sim" and bound is not None:
        eta = _measured_eta(arch, bound, fclk, device=device)
    else:
        eta = analytic_eta(arch, i_burst)
    stall = 0.3 if arch.fwd is ForwardTableKind.MULTIBANK_HASH else 0.0
    return HardwareParams(
        fclk_hz=fclk,
        pipeline_cycles=rep.pipeline_cycles,
        eta=eta,
        arb_cycles=_arb_cycles(arch, i_burst),
        ingress_stall_cycles=stall,
        report=rep,
    )
