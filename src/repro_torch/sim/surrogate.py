"""Statistical surrogate model (§IV-A.2).

Exploits the determinism of the FPGA datapath (fixed II, fixed pipeline
latency) to replace signal-level simulation with an event-driven *transaction*
model: packets flow through a greedy crossbar in arrival order, constrained by
input/output port availability and a back-annotated scheduler efficiency η.
Processes 10⁵-packet traces in milliseconds — the DSE's stage-2 engine.

Outputs (paper: "line-rate feasibility, BRAM lower bounds from peak VOQ
occupancy, and latency distributions"):
  * per-packet latency distribution (deterministic pipeline + queueing),
  * per-queue occupancy samples at arrival instants (PASTA) → stage-3 sizing,
  * sustained throughput.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.archspec import SwitchArch, VOQKind
from repro_torch.core.binding import BoundProtocol
from repro_torch.core.dse import SurrogateResult
from .backannotate import HardwareParams, annotate

__all__ = ["run_surrogate"]


def run_surrogate(
    arch: SwitchArch,
    bound: BoundProtocol,
    trace,
    *,
    hw: HardwareParams = None,
    back_annotation: bool = False,
    i_burst: float = 1.0,
) -> SurrogateResult:
    if hw is None:
        hw = annotate(arch, bound, source="cycle_sim" if back_annotation else "model",
                      i_burst=i_burst)
    n = arch.n_ports
    fclk = hw.fclk_hz

    t = np.asarray(trace.time_s, np.float64)
    src = np.asarray(trace.src, np.int64) % n
    dst = np.asarray(trace.dst, np.int64) % n
    payload = np.asarray(trace.payload_bytes, np.int64)
    order = np.argsort(t, kind="stable")
    t, src, dst, payload = t[order] - t.min(), src[order], dst[order], payload[order]
    m = t.size

    flit_bytes = arch.bus_bits // 8
    size_flits = np.maximum(1, -(-(payload + bound.header_bytes) // flit_bytes))
    svc = (size_flits + hw.ingress_stall_cycles) / (fclk * hw.eta)   # seconds

    # greedy crossbar: arrival-order admission against input/output availability
    in_free = np.zeros(n)
    out_free = np.zeros(n)
    dep_end = np.zeros(m)
    for k in range(m):
        i, j = src[k], dst[k]
        start = max(t[k], in_free[i], out_free[j])
        end = start + svc[k]
        in_free[i] = end
        out_free[j] = end
        dep_end[k] = end

    pipe_s = (hw.pipeline_cycles + hw.arb_cycles) / fclk
    latency_ns = (dep_end - t + pipe_s) * 1e9

    # per-(src,dst) queue occupancy at arrival instants (PASTA sampling)
    qid = src * n + dst
    occupancy = np.zeros(m, dtype=np.int64)
    for q in np.unique(qid):
        sel = np.nonzero(qid == q)[0]
        arr_q = t[sel]
        dep_q = dep_end[sel]          # FIFO within a queue -> nondecreasing
        departed = np.searchsorted(dep_q, arr_q, side="right")
        occupancy[sel] = np.arange(sel.size) - departed

    if arch.voq is VOQKind.SHARED:
        # shared central buffer: occupancy of the data store (packets in flight)
        departed_glob = np.searchsorted(np.sort(dep_end), t, side="right")
        shared_occ = np.arange(m) - departed_glob
    else:
        shared_occ = None

    duration = max(dep_end.max() - t.min(), 1e-12)
    thru = float((payload + bound.header_bytes).sum() * 8 / duration / 1e9)
    return SurrogateResult(
        q_occupancy=occupancy.astype(np.float64),
        latency_ns=latency_ns,
        throughput_gbps=thru,
        meta={
            "hw": hw,
            "shared_occupancy": shared_occ,
            "q_occ_max": int(occupancy.max()) if m else 0,
            "line_rate_feasible": bool(svc.mean() * fclk <= arch.ii * size_flits.mean() * 1.25),
        },
    )
