"""Event-driven network simulator — the ns-3 role in the SPAC stack (§IV-A.1).

Mirrors ns-3's four-layer node abstraction:

  application layer   → trace generators (``repro.traces``)
  host network stack  → the Custom Protocol Adapter: DSL-compiled driver
                        (header serialisation, optional seq_no retransmission)
  device layer        → host NIC serialisation at link rate
  channel layer       → propagation delay

The switch is a "SPAC Port Device" node modelling forwarding-table lookup,
finite VOQ buffering (drops!) and scheduling, parameterised by hardware
back-annotation (fclk, pipeline depth, η) so results reflect the generated
hardware.  This is the DSE's stage-4 verifier and the Table II harness.

``run_netsim`` is the serial reference (one heapq replay per candidate); the
batched fan-out lives in ``repro.sim.batched_netsim`` and shares the
``service_times`` / ``switch_arrival_times`` helpers below so the two paths
cannot drift numerically.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.archspec import SwitchArch, VOQKind
from repro_torch.core.binding import BoundProtocol
from repro_torch.core.dse import VerifyResult
from .backannotate import HardwareParams, annotate

__all__ = ["NetSimConfig", "run_netsim", "service_times", "switch_arrival_times"]


@dataclasses.dataclass
class NetSimConfig:
    prop_delay_s: float = 50e-9        # channel propagation (10 m fibre)
    retransmit: bool = False           # driver-level ARQ if protocol has seq_no
    rto_s: float = 20e-6
    max_retries: int = 3


def service_times(
    arch: SwitchArch, hw: HardwareParams, wire: np.ndarray, link_bps: float,
) -> Tuple[np.ndarray, float]:
    """Per-packet output occupancy + pipeline latency for one candidate.

    The occupancy is the slower of the switch datapath and the egress link;
    matching efficiency η caps the sustainable egress rate (a scheduler that
    matches 76% of slots delivers at most 0.76×line rate).  One home for the
    formula: both the serial verifier and the batched engine call this, so
    their service times are bit-identical.
    """
    fclk = hw.fclk_hz
    flit_bytes = arch.bus_bits // 8
    size_flits = np.maximum(1, -(-wire // flit_bytes))
    svc_switch = size_flits / fclk + hw.ingress_stall_cycles / fclk
    svc_egress = wire * 8 / (link_bps * hw.eta)
    svc = np.maximum(svc_switch / hw.eta, svc_egress)
    pipe_s = (hw.pipeline_cycles + hw.arb_cycles) / fclk
    return svc, pipe_s


def switch_arrival_times(
    t0: np.ndarray, src: np.ndarray, wire: np.ndarray, link_bps: float,
    prop_delay_s: float, n_ports: int,
) -> np.ndarray:
    """Host stack + NIC model: serialise each packet onto its source's link in
    generation order, then propagate.  Candidate-independent — the batched
    verifier computes this once and shares the event timeline across the
    whole batch."""
    host_free = np.zeros(n_ports)
    arr = np.empty(t0.size, np.float64)
    for k in np.argsort(t0, kind="stable"):
        start = max(t0[k], host_free[src[k]])
        tx = wire[k] * 8 / link_bps
        host_free[src[k]] = start + tx
        arr[k] = start + tx + prop_delay_s
    return arr


def run_netsim(
    arch: SwitchArch,
    bound: BoundProtocol,
    trace,
    *,
    hw: Optional[HardwareParams] = None,
    cfg: Optional[NetSimConfig] = None,
    back_annotation: bool = True,
    i_burst: float = 1.0,
    device=None,
) -> VerifyResult:
    if cfg is None:
        cfg = NetSimConfig()     # per call: NetSimConfig is mutable
    if hw is None:
        # device: where back-annotation runs the cycle-level switch
        hw = annotate(arch, bound, source="cycle_sim" if back_annotation else "model",
                      i_burst=i_burst, device=device)
    n = arch.n_ports
    link_bps = trace.link_gbps * 1e9
    can_retx = cfg.retransmit and bound.has("seq_no")

    t0 = np.asarray(trace.time_s, np.float64)
    src = np.asarray(trace.src, np.int64) % n
    dst = np.asarray(trace.dst, np.int64) % n
    payload = np.asarray(trace.payload_bytes, np.int64)
    m = t0.size
    wire = payload + bound.header_bytes
    svc, pipe_s = service_times(arch, hw, wire, link_bps)

    # host stack + NIC: serialise onto the link, then propagate
    arr = switch_arrival_times(t0, src, wire, link_bps, cfg.prop_delay_s, n)
    events: List[Tuple[float, int, int]] = [(arr[k], int(k), 0) for k in range(m)]
    heapq.heapify(events)         # pops in (switch_arrival_time, pkt) order

    in_free = np.zeros(n)
    out_free = np.zeros(n)
    q_dep: Dict[Tuple[int, int], List[float]] = {}     # per-VOQ departure heap
    shared_dep: List[float] = []                       # shared-buffer departures
    depth = arch.voq_depth
    shared_cap = n * depth

    latency = np.full(m, np.nan)
    drops = 0
    delivered_bits = 0.0
    t_end = 0.0

    while events:
        now, k, attempt = heapq.heappop(events)
        i, j = int(src[k]), int(dst[k])
        q = (i, j)
        dep = q_dep.setdefault(q, [])
        while dep and dep[0] <= now:
            heapq.heappop(dep)
        full = len(dep) >= depth
        if arch.voq is VOQKind.SHARED:
            while shared_dep and shared_dep[0] <= now:
                heapq.heappop(shared_dep)
            full = full or len(shared_dep) >= shared_cap
        if full:
            if can_retx and attempt < cfg.max_retries:
                heapq.heappush(events, (now + cfg.rto_s, k, attempt + 1))
            else:
                drops += 1
            continue
        start = max(now + pipe_s, in_free[i], out_free[j])
        end = start + svc[k]
        in_free[i] = end
        out_free[j] = end
        heapq.heappush(dep, end)
        if arch.voq is VOQKind.SHARED:
            heapq.heappush(shared_dep, end)
        latency[k] = (end + cfg.prop_delay_s - t0[k]) * 1e9
        delivered_bits += wire[k] * 8
        t_end = max(t_end, end)

    done = ~np.isnan(latency)
    lat = latency[done]
    duration = max(t_end - (float(t0.min()) if m else 0.0), 1e-12)
    return VerifyResult(
        p99_latency_ns=float(np.percentile(lat, 99)) if lat.size else math.inf,
        mean_latency_ns=float(lat.mean()) if lat.size else math.inf,
        drop_rate=drops / max(m, 1),
        throughput_gbps=delivered_bits / duration / 1e9,
        meta={"latency_ns": lat, "latency_full_ns": latency,
              "delivered": int(done.sum()), "offered": int(m),
              "hw": hw, "engine": "netsim"},
    )
