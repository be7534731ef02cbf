"""The fidelity ladder: every simulator rung behind one contract (§IV-A).

The paper's enabler is a *multi-fidelity simulation stack* the DSE climbs —
cheap models screen thousands of candidates, faithful simulation verifies the
survivors.  This registry makes the ladder explicit: every rung implements

    evaluate(arch, bound, trace, *, hw=None, ...)        -> VerifyResult
    evaluate_batch(archs, bound, trace, *, hw=None, ...) -> [VerifyResult]

so engines are swappable pipeline stages (a batched variant is either native
— one call for the whole batch — or the serial loop fallback).  Every rung
takes ``device`` (default: the first CUDA device): where its batched engine
runs, and where back-annotation runs the cycle-level switch.

    rung  engine             model                                   cost
    ----  -----------------  --------------------------------------  --------
      0   analytic           closed-form resource/timing model       ~µs
      1   surrogate          event-driven transaction model          ~ms
      2   batched_surrogate  one contention scan (CUDA), B at once   ~ms/batch
      2   batched_surrogate[kernel]  + segmented occupancy kernel    ~ms/batch
      3   netsim             finite buffers, drops, retransmission   ~100ms
      3   batched_netsim     the same model, one ring scan (CUDA)    ~ms/cand
      3   batched_netsim[kernel]  segmented fixed-point kernel       ~µs/cand
      4   cycle              cycle-accurate switch datapath          ~s

Who uses which rung: DSE stage 1 prices candidates with the rung-0 resource
model, stage 2 screens through rung 2 (`DSEProblem.surrogate_batch`), stage 4
verifies through rung 3 (`DSEProblem.verify_batch`), and the
``verify_engine="auto"`` policy escalates only the champion to rung 4 —
so the expensive cycle-accurate datapath runs O(1) times per DSE, not O(B).

``VerifyResult.meta["engine"]`` names the rung that produced a result;
rung-1/2 results report ``drop_rate=0.0`` honestly (infinite buffers by
construction — sizing happens *after* them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.archspec import SwitchArch
from repro_torch.core.binding import BoundProtocol
from repro_torch.core.dse import SurrogateResult, VerifyResult

from .backannotate import HardwareParams, annotate
from .batched_netsim import run_netsim_batched
from .batched_surrogate import run_surrogate_batched
from .netsim import run_netsim
from .surrogate import run_surrogate

__all__ = ["EngineSpec", "ENGINES", "get_engine", "ladder", "register_engine"]


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One rung of the fidelity ladder.

    ``evaluate`` and ``evaluate_batch`` share the keyword surface
    ``(hw=None, back_annotation=False, i_burst=1.0, device=None)``; ``batched`` records
    whether ``evaluate_batch`` is native (one call for the whole batch) or
    the serial loop fallback."""

    name: str
    rung: int
    evaluate: Callable[..., VerifyResult]
    evaluate_batch: Callable[..., List[VerifyResult]]
    batched: bool
    doc: str = ""


ENGINES: Dict[str, EngineSpec] = {}


def register_engine(
    name: str,
    rung: int,
    evaluate: Callable[..., VerifyResult],
    evaluate_batch: Optional[Callable[..., List[VerifyResult]]] = None,
    doc: str = "",
) -> EngineSpec:
    """Add a rung; without ``evaluate_batch`` the serial loop stands in."""
    batched = evaluate_batch is not None
    if evaluate_batch is None:
        def evaluate_batch(archs, bound, trace, **kw):
            return [evaluate(a, bound, trace, **kw) for a in archs]
    spec = EngineSpec(name=name, rung=rung, evaluate=evaluate,
                      evaluate_batch=evaluate_batch, batched=batched, doc=doc)
    ENGINES[name] = spec
    return spec


def get_engine(name: str) -> EngineSpec:
    try:
        return ENGINES[name]
    except KeyError:
        raise KeyError(f"unknown engine {name!r}; known: {sorted(ENGINES)}") from None


def ladder() -> List[EngineSpec]:
    """The registered rungs, cheapest first."""
    return sorted(ENGINES.values(), key=lambda e: (e.rung, e.name))


def _annotate(arch, bound, hw, back_annotation, i_burst, device=None) -> HardwareParams:
    if hw is not None:
        return hw
    return annotate(arch, bound,
                    source="cycle_sim" if back_annotation else "model",
                    i_burst=i_burst, device=device)


# --------------------------------------------------------------------------
# rung 0 — analytic: no trace replay at all
# --------------------------------------------------------------------------

def _analytic_evaluate(
    arch: SwitchArch, bound: BoundProtocol, trace, *,
    hw: Optional[HardwareParams] = None, back_annotation: bool = False,
    i_burst: float = 1.0, device=None,
) -> VerifyResult:
    """Unloaded pipeline latency + mean-packet serialisation; throughput is
    the offered load capped by the datapath's sustainable rate.  Queueing and
    drops are invisible at this rung — it prices candidates, it does not
    verify them."""
    hw = _annotate(arch, bound, hw, back_annotation, i_burst, device)
    payload = np.asarray(trace.payload_bytes, np.float64)
    mean_wire = float(payload.mean()) + bound.header_bytes if payload.size \
        else float(bound.header_bytes)
    flits = max(1.0, math.ceil(mean_wire / (arch.bus_bits / 8)))
    svc_s = (flits + hw.ingress_stall_cycles) / (hw.fclk_hz * hw.eta)
    lat_ns = ((hw.pipeline_cycles + hw.arb_cycles) / hw.fclk_hz + svc_s) * 1e9
    cap_gbps = arch.bus_bits * hw.fclk_hz * hw.eta / arch.ii / 1e9
    offered = trace.offered_gbps(bound.header_bytes) if len(trace) else 0.0
    return VerifyResult(
        p99_latency_ns=lat_ns, mean_latency_ns=lat_ns, drop_rate=0.0,
        throughput_gbps=min(offered, cap_gbps),
        meta={"hw": hw, "engine": "analytic", "capacity_gbps": cap_gbps})


def _analytic_batch(archs, bound, trace, *, hw=None, back_annotation=False,
                    i_burst=1.0, device=None) -> List[VerifyResult]:
    archs = list(archs)
    hw = list(hw) if hw is not None else [None] * len(archs)
    return [_analytic_evaluate(a, bound, trace, hw=h,
                               back_annotation=back_annotation, i_burst=i_burst,
                               device=device)
            for a, h in zip(archs, hw)]


# --------------------------------------------------------------------------
# rungs 1+2 — the infinite-buffer transaction model
# --------------------------------------------------------------------------

def _surrogate_to_verify(sr: SurrogateResult) -> VerifyResult:
    lat = sr.latency_ns
    return VerifyResult(
        p99_latency_ns=sr.p(99),
        mean_latency_ns=float(lat.mean()) if lat.size else math.inf,
        drop_rate=0.0,                      # infinite buffers by construction
        throughput_gbps=sr.throughput_gbps,
        meta={**sr.meta, "engine": "surrogate",
              "q_occupancy": sr.q_occupancy})


def _surrogate_evaluate(arch, bound, trace, *, hw=None, back_annotation=False,
                        i_burst=1.0, device=None) -> VerifyResult:
    return _surrogate_to_verify(run_surrogate(
        arch, bound, trace, hw=hw, back_annotation=back_annotation,
        i_burst=i_burst, device=device))


def _batched_surrogate_batch(archs, bound, trace, *, hw=None,
                             back_annotation=False, i_burst=1.0, mesh=None,
                             use_kernel=False, device=None):
    res = run_surrogate_batched(list(archs), bound, trace, hw=hw,
                                back_annotation=back_annotation,
                                i_burst=i_burst, mesh=mesh,
                                use_kernel=use_kernel, device=device)
    return [_surrogate_to_verify(sr) for sr in res.results()]


def _batched_surrogate_evaluate(arch, bound, trace, *, hw=None,
                                back_annotation=False, i_burst=1.0,
                                device=None):
    return _batched_surrogate_batch(
        [arch], bound, trace, hw=[hw] if hw is not None else None,
        back_annotation=back_annotation, i_burst=i_burst, device=device)[0]


def _batched_surrogate_kernel_batch(archs, bound, trace, *, hw=None,
                                    back_annotation=False, i_burst=1.0,
                                    mesh=None, device=None):
    return _batched_surrogate_batch(
        archs, bound, trace, hw=hw, back_annotation=back_annotation,
        i_burst=i_burst, mesh=mesh, use_kernel=True, device=device)


def _batched_surrogate_kernel_evaluate(arch, bound, trace, *, hw=None,
                                       back_annotation=False, i_burst=1.0,
                                       device=None):
    return _batched_surrogate_kernel_batch(
        [arch], bound, trace, hw=[hw] if hw is not None else None,
        back_annotation=back_annotation, i_burst=i_burst, device=device)[0]


# --------------------------------------------------------------------------
# rung 3 — the finite-buffer event-driven verifier
# --------------------------------------------------------------------------

def _netsim_evaluate(arch, bound, trace, *, hw=None, back_annotation=False,
                     i_burst=1.0, cfg=None, device=None) -> VerifyResult:
    return run_netsim(arch, bound, trace, hw=hw, cfg=cfg,
                      back_annotation=back_annotation, i_burst=i_burst,
                      device=device)


def _batched_netsim_batch(archs, bound, trace, *, hw=None,
                          back_annotation=False, i_burst=1.0, cfg=None,
                          mesh=None, use_kernel=False, device=None):
    return run_netsim_batched(list(archs), bound, trace, hw=hw, cfg=cfg,
                              back_annotation=back_annotation,
                              i_burst=i_burst, mesh=mesh,
                              use_kernel=use_kernel, device=device)


def _batched_netsim_evaluate(arch, bound, trace, *, hw=None,
                             back_annotation=False, i_burst=1.0, cfg=None,
                             device=None):
    return _batched_netsim_batch(
        [arch], bound, trace, hw=[hw] if hw is not None else None,
        back_annotation=back_annotation, i_burst=i_burst, cfg=cfg,
        device=device)[0]


def _batched_netsim_kernel_batch(archs, bound, trace, *, hw=None,
                                 back_annotation=False, i_burst=1.0, cfg=None,
                                 mesh=None, device=None):
    return _batched_netsim_batch(
        archs, bound, trace, hw=hw, back_annotation=back_annotation,
        i_burst=i_burst, cfg=cfg, mesh=mesh, use_kernel=True, device=device)


def _batched_netsim_kernel_evaluate(arch, bound, trace, *, hw=None,
                                    back_annotation=False, i_burst=1.0,
                                    cfg=None, device=None):
    return _batched_netsim_kernel_batch(
        [arch], bound, trace, hw=[hw] if hw is not None else None,
        back_annotation=back_annotation, i_burst=i_burst, cfg=cfg,
        device=device)[0]


# --------------------------------------------------------------------------
# rung 4 — the cycle-accurate switch datapath
# --------------------------------------------------------------------------

def _cycle_evaluate(arch, bound, trace, *, hw=None, back_annotation=False,
                    i_burst=1.0, max_cycles=None, device=None) -> VerifyResult:
    """Rung 4: the cycle-level switch on ``device``, the candidate's
    custom-kernel hooks included (on a card: the switch loop's ingress
    pass, the hooks on the host, its egress pass)."""
    from repro_torch.switch.switch import simulate
    hw = _annotate(arch, bound, hw, back_annotation, i_burst, device)
    res = simulate(arch, bound, trace, fclk_hz=hw.fclk_hz,
                   max_cycles=max_cycles, device=device)
    lat = res.latency_ns
    return VerifyResult(
        p99_latency_ns=res.p(99),
        mean_latency_ns=float(lat.mean()) if lat.size else math.inf,
        drop_rate=res.drop_rate,
        throughput_gbps=res.throughput_gbps,
        meta={"hw": hw, "engine": "cycle", "cycle": res})


register_engine(
    "analytic", 0, _analytic_evaluate, _analytic_batch,
    doc="closed-form resource/timing model; prices candidates, no queueing")
register_engine(
    "surrogate", 1, _surrogate_evaluate,
    doc="serial event-driven transaction model, infinite buffers")
register_engine(
    "batched_surrogate", 2, _batched_surrogate_evaluate,
    _batched_surrogate_batch,
    doc="the transaction model as one contention scan over the batch")
register_engine(
    "batched_surrogate[kernel]", 2, _batched_surrogate_kernel_evaluate,
    _batched_surrogate_kernel_batch,
    doc="rung 2 with the segmented occupancy kernel (bit-identical counts)")
register_engine(
    "netsim", 3, _netsim_evaluate,
    doc="finite-buffer event-driven verifier (drops, retransmission)")
register_engine(
    "batched_netsim", 3, _batched_netsim_evaluate, _batched_netsim_batch,
    doc="the finite-buffer verifier as one ring scan, sized depths batched")
register_engine(
    "batched_netsim[kernel]", 3, _batched_netsim_kernel_evaluate,
    _batched_netsim_kernel_batch,
    doc="rung 3 via the segmented fixed-point kernel (lean replay + chain "
        "admission), bit-identical results, serial-oracle fallback on "
        "unconverged rows")
register_engine(
    "cycle", 4, _cycle_evaluate,
    doc="cycle-accurate switch datapath (the repo's 'real hardware')")
