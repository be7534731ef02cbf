"""Hardware back-annotation (§IV-A.1).

The paper injects performance metrics from physical FPGA runs into the
simulators.  Our "physical hardware" is the cycle-level switch
(``repro.switch`` in the JAX package, not ported yet; until it is,
``annotate(..., source="cycle_sim")`` raises).  It runs a short saturation
trace through it and measures the achieved scheduler efficiency η
(matching quality) per (scheduler, ports, VOQ) family, caching the result.
``source="model"`` uses the analytic defaults instead (fast functional mode) —
the user-facing accuracy/speed toggle the paper describes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


def _measured_eta(arch: SwitchArch, bound: BoundProtocol, fclk_hz: float) -> float:
    """Run a short saturation trace through the cycle-level switch; measure the
    achieved output utilisation = matching efficiency."""
    raise NotImplementedError(
        "back_annotation / source='cycle_sim' needs the cycle-level switch, "
        "which is not ported to repro_torch yet (ROADMAP queue 1, item 6); "
        "pass back_annotation=False for the analytic eta")


def annotate(
    arch: SwitchArch,
    bound: Optional[BoundProtocol] = None,
    *,
    source: str = "model",
    i_burst: float = 1.0,
) -> HardwareParams:
    rep = synthesize(arch, bound)
    fclk = rep.fmax_mhz * 1e6
    if source == "cycle_sim" and bound is not None:
        eta = _measured_eta(arch, bound, fclk)
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
