"""Batched stage-2 surrogate engine (§IV-A.2 at fan-out scale).

``run_surrogate`` evaluates one ``(arch, depths)`` candidate per call with a
Python-loop crossbar — fine for a handful of candidates, hopeless for the
thousands Algorithm 1's stage 2 wants to screen.  This module reformulates
the event-driven transaction model as a *sorted-arrival scan over a shared
trace* in which every per-candidate parameter (bus width, pipeline depth, η,
ingress stalls, f_clk) is a batch axis:

  * the greedy-crossbar recurrence runs as one launch of the hand-written
    CUDA scan (``repro_torch.kernels.xbar``; its plain PyTorch version on
    the CPU) with per-row port state, and the sustained throughput is
    reduced on the same device; latency (one broadcast) and its quantiles
    reduce on the host with NumPy, as in the JAX package,
  * exact per-VOQ occupancy counting (PASTA sampling) is integer math done
    once on the host from the batched departure times — bit-identical to the
    serial path, so stage-3 sizing and drop counts cannot drift.

Precision: with ``precision="float64"`` (default) the scan runs in float64
so departure times match the serial float64 model exactly;
``precision="float32"`` runs the slack form (the Pallas tile's contract in
the JAX package: the scan carries arrival-relative *slacks*, never absolute
timestamps, so f32 still holds queueing-delay precision on arbitrarily long
traces).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.analysis.retrace import track
from repro_torch.core.archspec import SwitchArch, VOQKind
from repro_torch.core.binding import BoundProtocol
from repro_torch.core.dse import SurrogateResult
from repro_torch.device import resolve_device

from .backannotate import HardwareParams, annotate
from .timeline import stage2_timeline
from repro_torch.kernels.netsim import resolve_use_kernel, segmented_occupancy
from repro_torch.kernels.xbar import xbar_contend

__all__ = ["BatchedSurrogateResult", "run_surrogate_batched", "DEFAULT_QUANTILES"]

DEFAULT_QUANTILES = (50.0, 90.0, 99.0)


def _engine_impl(dt, src, dst, svc, t, wire_bits, *, n_ports):
    """One call on ``svc``'s device: contention scan + throughput.

    Latency (one broadcast over dep) and quantile reduction stay on the
    host, as in the JAX package: returning the [B, m] latency matrix would
    double the largest device-to-host transfer.  Rowwise over the candidate
    axis (per-candidate carries, shared timeline)."""
    dep = xbar_contend(t, dt, src, dst, svc, n_ports=n_ports)
    # dep is absolute on the f64 path, an arrival-relative offset on f32
    absolute = dep.dtype == torch.float64
    dep_end = dep if absolute else t[None, :] + dep
    duration = torch.clamp_min(torch.amax(dep_end, dim=1), 1e-12)
    # the reference writes ``/ 1e9``; XLA compiles a division by a constant
    # to a multiplication by its reciprocal, and the port repeats what runs
    thru = wire_bits / duration * 1e-9                          # [B] Gbps
    return dep, thru


_engine = track("surrogate.engine", _engine_impl, static_argnames=("n_ports",))


def _exact_occupancy(t, qid, dep):
    """Per-VOQ occupancy at arrival instants for every candidate at once.

    Serial reference loops ``np.searchsorted`` per queue; here one
    searchsorted per candidate row covers all queues: keys ``qid*span + time``
    order departures queue-major (FIFO keeps them sorted inside a queue).
    All float64 — the counts are exact integers identical to the serial
    model's.  The key spends ~log2(n_ports²) mantissa bits on the queue id,
    leaving time resolution of span·n²·2⁻⁵² (≈ femtoseconds even at 1024
    ports — far below any physical service-time margin); the candidate axis
    deliberately stays a Python loop rather than a third key term so batch
    size cannot erode that budget.
    """
    b_n, m = dep.shape
    order = np.argsort(qid, kind="stable")
    g = qid[order]
    first = np.ones(m, bool)
    first[1:] = g[1:] != g[:-1]
    run_starts = np.nonzero(first)[0]
    run_ids = np.cumsum(first) - 1
    rank_grouped = np.arange(m) - run_starts[run_ids]
    rank = np.empty(m, np.int64)
    rank[order] = rank_grouped                 # arrivals-before-me in my queue
    qstart = np.empty(m, np.int64)
    qstart[order] = run_starts[run_ids]        # my queue's block start position

    span = max(float(dep.max(initial=0.0)), float(t.max(initial=0.0))) + 1.0
    key_arr = qid * span + t
    occ = np.empty((b_n, m), np.int64)
    for b in range(b_n):
        key_dep = g * span + dep[b, order]
        departed = np.searchsorted(key_dep, key_arr, side="right") - qstart
        occ[b] = rank - departed
    return occ                                 # [B, m] int64


@dataclasses.dataclass
class BatchedSurrogateResult:
    """Stage-2 fan-out output: [B, ...] arrays over the candidate batch."""

    archs: List[SwitchArch]
    hw: List[HardwareParams]
    latency_ns: np.ndarray         # [B, m] per-packet latency
    quantiles: np.ndarray          # [B, nq] latency quantiles (ns)
    quantile_qs: Sequence[float]   # the nq percentile points
    throughput_gbps: np.ndarray    # [B]
    q_occupancy: np.ndarray        # [B, m] exact per-VOQ occupancy samples
    dep_end_s: np.ndarray          # [B, m] absolute departure times
    t_s: np.ndarray                # [m] shared arrival times (t[0] == 0)
    line_rate_feasible: np.ndarray  # [B] bool
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def peak_occupancy(self) -> np.ndarray:
        """[B] — the BRAM lower bound the paper reads off stage 2."""
        return self.q_occupancy.max(axis=1, initial=0)

    def occupancy_hist(self) -> np.ndarray:
        """[B, peak+1] histogram of occupancy samples (shared bin edges)."""
        b, m = self.q_occupancy.shape
        occ = np.maximum(self.q_occupancy, 0)
        width = int(occ.max(initial=0)) + 1
        flat = (np.arange(b)[:, None] * width + occ).reshape(-1)
        return np.bincount(flat, minlength=b * width).reshape(b, width)

    def results(self) -> List[SurrogateResult]:
        """Materialise per-candidate ``SurrogateResult``s (serial-compatible)."""
        out = []
        shared_rows = [b for b, a in enumerate(self.archs)
                       if a.voq is VOQKind.SHARED]
        if shared_rows:
            # sort all shared rows at once instead of one np.sort per
            # candidate inside the loop below
            sorted_dep = np.sort(self.dep_end_s[shared_rows], axis=1)
            sorted_of = {b: sorted_dep[i] for i, b in enumerate(shared_rows)}
        for b, (arch, hw) in enumerate(zip(self.archs, self.hw)):
            if arch.voq is VOQKind.SHARED:
                m = self.t_s.size
                departed = np.searchsorted(sorted_of[b], self.t_s,
                                           side="right")
                shared_occ = np.arange(m) - departed
            else:
                shared_occ = None
            out.append(SurrogateResult(
                q_occupancy=self.q_occupancy[b].astype(np.float64),
                latency_ns=self.latency_ns[b],
                throughput_gbps=float(self.throughput_gbps[b]),
                meta={
                    "hw": hw,
                    "shared_occupancy": shared_occ,
                    "q_occ_max": int(self.q_occupancy[b].max(initial=0)),
                    "line_rate_feasible": bool(self.line_rate_feasible[b]),
                    "batched": True,
                },
            ))
        return out


def _run_group(archs, bounds, trace, hw_list, precision, quantiles, device,
               use_kernel=False):
    """All candidates share n_ports; every other parameter — including the
    protocol's header wire-bytes under co-design — is a batch axis.  The
    shared arrival timeline is the trace's (candidate-independent), so mixed
    header widths still ride one scan: the header only reshapes the
    per-candidate service times and delivered wire bits."""
    n = archs[0].n_ports
    tl2 = stage2_timeline(trace, n)
    t, src, dst, payload = tl2.t, tl2.src, tl2.dst, tl2.payload
    m = t.size

    b_n = len(archs)
    svc = np.empty((b_n, m), np.float64)
    pipe_s = np.empty(b_n, np.float64)
    feasible = np.empty(b_n, bool)
    wire_bits = np.empty(b_n, np.float64)
    # one wire-size array per distinct header width: classic shared-bound
    # batches pay for it once, co-design pays once per layout width
    wire_cache: Dict[int, Any] = {}
    for b, (arch, bound, hw) in enumerate(zip(archs, bounds, hw_list)):
        cached = wire_cache.get(bound.header_bytes)
        if cached is None:
            wb = payload + bound.header_bytes
            cached = (wb, float(wb.sum() * 8))
            wire_cache[bound.header_bytes] = cached
        wire_bytes, wire_bits[b] = cached
        flit_bytes = arch.bus_bits // 8
        size_flits = np.maximum(1, -(-wire_bytes // flit_bytes))
        svc[b] = (size_flits + hw.ingress_stall_cycles) / (hw.fclk_hz * hw.eta)
        pipe_s[b] = (hw.pipeline_cycles + hw.arb_cycles) / hw.fclk_hz
        feasible[b] = bool(m == 0 or svc[b].mean() * hw.fclk_hz
                           <= arch.ii * size_flits.mean() * 1.25)

    dtype = torch.float64 if precision == "float64" else torch.float32
    if m == 0:
        dep = np.zeros((b_n, 0))
        thru = np.zeros(b_n)
    else:
        def on_device(a, dt_):
            return torch.tensor(a, dtype=dt_, device=device)
        dep_d, thru_d = _engine(
            on_device(tl2.dt, dtype), on_device(src, torch.int32),
            on_device(dst, torch.int32), on_device(svc, dtype),
            on_device(t, dtype), on_device(wire_bits, dtype), n_ports=n)
        dep = dep_d.cpu().numpy().astype(np.float64, copy=False)
        thru = thru_d.cpu().numpy().astype(np.float64, copy=False)
        del dep_d, thru_d
    if precision == "float64":
        # the f64 scan returns absolute departure times so the occupancy
        # comparisons below see the serial path's exact values (no offset
        # round-trip); latency then subtracts t exactly as the serial model
        dep_end = np.asarray(dep, np.float64)
        lat = (dep_end - t[None, :] + pipe_s[:, None]) * 1e9
    else:
        dep_end = t[None, :] + np.asarray(dep, np.float64)
        lat = (dep + pipe_s[:, None]) * 1e9
    quant = (np.percentile(lat, quantiles, axis=1).T if m
             else np.zeros((b_n, len(quantiles))))
    if m == 0:
        occupancy = np.zeros((b_n, 0), np.int64)
    elif use_kernel:
        # one flat searchsorted over the whole [B, m] block (chain structure
        # from the trace memo) — integer counts bit-identical to the serial
        # per-row reference
        occupancy = segmented_occupancy(np.asarray(t), dep_end, tl2.chain)
    else:
        occupancy = _exact_occupancy(t, tl2.qid, dep_end)
    return BatchedSurrogateResult(
        archs=list(archs), hw=list(hw_list),
        latency_ns=np.asarray(lat, np.float64),
        quantiles=np.asarray(quant, np.float64), quantile_qs=tuple(quantiles),
        throughput_gbps=np.asarray(thru, np.float64),
        q_occupancy=occupancy, dep_end_s=dep_end, t_s=t,
        line_rate_feasible=feasible,
        meta={"n_ports": n, "precision": precision,
              "use_kernel": bool(use_kernel), "device": str(device)},
    )


def run_surrogate_batched(
    archs: Sequence[SwitchArch],
    bound: Union[BoundProtocol, Sequence[BoundProtocol]],
    trace,
    *,
    hw: Optional[Sequence[HardwareParams]] = None,
    back_annotation: bool = False,
    i_burst: float = 1.0,
    precision: str = "float64",
    quantiles: Sequence[float] = DEFAULT_QUANTILES,
    use_kernel=False,
    device=None,
) -> BatchedSurrogateResult:
    """Evaluate a whole candidate batch against one shared trace.

    ``device`` (default: the first CUDA device; raises without one) is where
    the contention scan runs: the hand-written CUDA kernel on a card, its
    plain PyTorch version for ``device="cpu"``.

    ``bound`` is one ``BoundProtocol`` shared by the batch, or — for the
    protocol/architecture co-design DSE — a per-candidate sequence (index-
    aligned with ``archs``): header wire-bytes then become a batch axis like
    bus width and η, and the batch still costs one scan (the arrival
    timeline is the trace's, never rebuilt per candidate).

    Candidates may mix every architectural policy; only ``n_ports`` is a
    structural axis, so mixed-port batches are partitioned internally and the
    per-group results are stitched back in input order.

    ``precision="float32"`` runs the float32 slack-form scan, the port's
    counterpart of the JAX package's ``use_pallas=True``.

    ``use_kernel`` (``"auto"``/``"on"``/``"off"`` or a bool) switches the
    exact occupancy count to the segmented flat-searchsorted pass
    (``repro_torch.kernels.netsim.segmented_occupancy``) — bit-identical
    integer counts, one pass over the whole batch instead of one per
    candidate.

    Memory: the result holds per-candidate sample arrays ([B, m] latencies,
    occupancy and departure times — stage 3 consumes the samples), so host
    memory scales as O(B·m); at ~1e5-packet traces budget ~2.5 MB/candidate
    and chunk very large sweeps into multiple calls.
    """
    use_kernel = resolve_use_kernel(use_kernel)
    if precision not in ("float64", "float32"):
        raise ValueError(f"precision must be 'float64' or 'float32', "
                         f"got {precision!r}")
    device = resolve_device(device)
    archs = list(archs)
    bounds = (list(bound) if isinstance(bound, (list, tuple))
              else [bound] * len(archs))
    if len(bounds) != len(archs):
        raise ValueError(f"bound has {len(bounds)} entries for {len(archs)} "
                         "archs; they must be index-aligned")
    if not archs:
        return BatchedSurrogateResult(
            archs=[], hw=[], latency_ns=np.zeros((0, 0)),
            quantiles=np.zeros((0, len(quantiles))), quantile_qs=tuple(quantiles),
            throughput_gbps=np.zeros(0), q_occupancy=np.zeros((0, 0), np.int64),
            dep_end_s=np.zeros((0, 0)), t_s=np.zeros(0),
            line_rate_feasible=np.zeros(0, bool))
    if hw is None:
        source = "cycle_sim" if back_annotation else "model"
        hw = [annotate(a, b, source=source, i_burst=i_burst, device=device)
              for a, b in zip(archs, bounds)]
    hw = list(hw)
    if len(hw) != len(archs):
        raise ValueError(f"hw has {len(hw)} entries for {len(archs)} archs; "
                         "they must be index-aligned")

    groups: Dict[int, List[int]] = {}
    for i, a in enumerate(archs):
        groups.setdefault(a.n_ports, []).append(i)
    if len(groups) == 1:
        return _run_group(archs, bounds, trace, hw, precision, quantiles,
                          device, use_kernel=use_kernel)

    parts = {n: _run_group([archs[i] for i in idx], [bounds[i] for i in idx],
                           trace, [hw[i] for i in idx], precision, quantiles,
                           device, use_kernel=use_kernel)
             for n, idx in groups.items()}
    # stitch [B, m] arrays back in input order (m is shared: one trace)
    first = next(iter(parts.values()))
    merged = BatchedSurrogateResult(
        archs=archs, hw=hw,
        latency_ns=np.empty((len(archs),) + first.latency_ns.shape[1:]),
        quantiles=np.empty((len(archs), len(quantiles))),
        quantile_qs=tuple(quantiles),
        throughput_gbps=np.empty(len(archs)),
        q_occupancy=np.empty((len(archs),) + first.q_occupancy.shape[1:], np.int64),
        dep_end_s=np.empty((len(archs),) + first.dep_end_s.shape[1:]),
        t_s=first.t_s, line_rate_feasible=np.empty(len(archs), bool),
        meta={"precision": precision, "use_kernel": bool(use_kernel),
              "device": str(device)})
    for n, idx in groups.items():
        part = parts[n]
        for row, i in enumerate(idx):
            merged.latency_ns[i] = part.latency_ns[row]
            merged.quantiles[i] = part.quantiles[row]
            merged.throughput_gbps[i] = part.throughput_gbps[row]
            merged.q_occupancy[i] = part.q_occupancy[row]
            merged.dep_end_s[i] = part.dep_end_s[row]
            merged.line_rate_feasible[i] = part.line_rate_feasible[row]
    return merged
