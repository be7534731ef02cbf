"""Batched stage-4 verifier (§IV-A.1 at fan-out scale).

``run_netsim`` replays the event-driven, finite-buffer switch model one
candidate at a time through a Python heapq loop.  This module verifies a
whole sized-candidate batch against the *shared* event timeline, with every
per-candidate parameter — bus width, η, pipeline/arbitration cycles, ingress
stalls, f_clk and the stage-3 **sized VOQ depths** — as a batch axis.

Two engines, as in the JAX package, selected by ``use_kernel``:

* the ring scan (``use_kernel=False``/``"off"``, the default): one float64
  scan over the timeline in which a ``[B, N², D]`` ring of departure times,
  indexed by admission count, answers each VOQ's fullness check in O(1) —
  departures inside a VOQ are FIFO, so "queue (i,j) holds ``depth``
  undeparted packets at t" is "the packet admitted ``depth`` admissions
  ago has not departed by t", and the slot an admission is about to
  overwrite *is* that packet.  On the card it is the hand-written kernel
  of ``repro_torch.kernels.ring_scan``.
* the segmented-kernel engine (``"auto"``/``"on"``/True): the speculative
  fixed point of ``repro_torch.kernels.netsim``.  Round 1 replays every row
  with all packets admitted (the CUDA kernel on the card) and checks on the
  device whether any VOQ would have been full; rows that dropped iterate a
  gated replay against host-side segmented admission until they close.

``VOQKind.SHARED`` adds a global cap (``N·depth`` packets in flight across
the whole buffer) whose count is *not* FIFO across queues, so it is settled
exactly in a second, host-side pass: the engine runs unconstrained by the
cap, then for each shared candidate the in-flight timeline ``G(t_k) =
admitted-before-k − #(ends ≤ t_k)`` is reconstructed vectorially (one sort +
searchsorted).  If the cap was never reached at an admitted event, the
unconstrained run *is* the constrained run and the batched result is exact;
the rare candidates whose cap does bind fall back to the serial heapq
oracle — exact by definition, and flagged in ``meta["shared_cap_fallback"]``
so throughput reports stay honest.

Both engines run in float64 and share ``service_times`` /
``switch_arrival_times`` with the serial path, so admission decisions, drop
counts and departure times are bit-identical to ``run_netsim``.

Retransmission (driver ARQ) inserts events dynamically and stays on the
serial path: ``run_netsim_batched`` raises ``NotImplementedError`` for
retransmitting configs so callers fall back honestly instead of silently
diverging.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.analysis.retrace import track
from repro_torch.core.archspec import SwitchArch, VOQKind
from repro_torch.core.binding import BoundProtocol
from repro_torch.core.dse import VerifyResult
from repro_torch.device import resolve_device
from repro_torch.kernels.netsim import netsim_fixed_point, resolve_use_kernel
from repro_torch.kernels.netsim.ops import _on
from repro_torch.kernels.ring_scan import ring_scan

from .backannotate import HardwareParams, annotate
from .netsim import NetSimConfig, run_netsim, service_times
from .timeline import stage4_timeline

#: the ring-scan engine ``use_kernel="off"`` runs, tracked under the JAX
#: package's name for its ``lax.scan`` engine
_verify_engine = track("netsim.engine", ring_scan,
                       static_argnames=("n_ports", "d_max"))

__all__ = ["run_netsim_batched"]


def _shared_cap_ok(admit_b: np.ndarray, sorted_ends_b: np.ndarray,
                   now: np.ndarray, cap: int) -> bool:
    """True iff the shared-buffer cap never binds in the unconstrained run.

    ``G(t_k) = admitted-before-k − #(admitted ends ≤ t_k)`` is the exact
    in-flight count the serial path's shared heap sees at event k (later
    admissions end strictly after t_k, so counting departures over *all*
    admitted ends is safe).  If G < cap at every per-queue-admitted event,
    the cap could never have dropped a packet and the unconstrained dynamics
    are the true dynamics.

    ``sorted_ends_b`` is the candidate's ascending departure times with
    dropped events mapped to +inf — sorted once for the whole batch by the
    caller (one ``np.sort(where(admit, end, inf), axis=1)``) instead of a
    fresh per-candidate ``np.sort`` inside the loop; the inf tail never
    lands left of a finite ``now``, so ``side="right"`` counts are
    unchanged."""
    g_before = np.cumsum(admit_b) - admit_b
    departed = np.searchsorted(sorted_ends_b, now, side="right")
    return not bool(np.any(admit_b & (g_before - departed >= cap)))


def _sorted_admitted_ends(end: np.ndarray, admit: np.ndarray,
                         rows: Sequence[int]) -> Dict[int, np.ndarray]:
    """Batched replacement for the per-candidate ``np.sort`` the shared-cap
    check used to do: one sort over the selected rows, dropped events pushed
    to +inf so every row shares one [len(rows), m] sort."""
    if not rows:
        return {}
    idx = np.asarray(rows)
    sorted_ends = np.sort(np.where(admit[idx], end[idx], np.inf), axis=1)
    return {int(b): sorted_ends[i] for i, b in enumerate(idx)}


def _empty_result(hw: HardwareParams) -> VerifyResult:
    return VerifyResult(
        p99_latency_ns=math.inf, mean_latency_ns=math.inf, drop_rate=0.0,
        throughput_gbps=0.0,
        meta={"latency_ns": np.zeros(0), "latency_full_ns": np.zeros(0),
              "delivered": 0, "offered": 0,
              "hw": hw, "engine": "batched_netsim"})


def _metrics_result(end_b, admit_b, order, t0, wire_e, t0_min, cfg, hw,
                    m) -> VerifyResult:
    """Reduce one candidate's (end, admit) to a VerifyResult — verbatim the
    default path's reduction, so kernel-path results are bit-identical."""
    latency = np.full(m, np.nan)
    latency[order] = np.where(
        admit_b, (end_b + cfg.prop_delay_s - t0[order]) * 1e9, np.nan)
    done = ~np.isnan(latency)
    lat = latency[done]
    t_end = float(np.max(end_b, where=admit_b, initial=0.0))
    delivered_bits = float(int(wire_e[admit_b].sum()) * 8)
    duration = max(t_end - t0_min, 1e-12)
    return VerifyResult(
        p99_latency_ns=float(np.percentile(lat, 99)) if lat.size else math.inf,
        mean_latency_ns=float(lat.mean()) if lat.size else math.inf,
        drop_rate=int((~admit_b).sum()) / max(m, 1),
        throughput_gbps=delivered_bits / duration / 1e9,
        meta={"latency_ns": lat, "latency_full_ns": latency,
              "delivered": int(done.sum()),
              "offered": int(m), "hw": hw, "engine": "batched_netsim"},
    )


def _run_group(archs, bounds, trace, hw_list, cfg,
               device) -> List[VerifyResult]:
    """The ring-scan engine.  All candidates share n_ports *and* header
    wire-bytes; every other parameter is a batch axis.  The header width is
    structural here — unlike stage 2, the event timeline (host-NIC
    serialisation) depends on wire size, so mixed-header co-design batches
    are partitioned by ``header_bytes`` upstream and each partition shares
    one timeline."""
    n = archs[0].n_ports
    tl4 = stage4_timeline(trace, n, bounds[0].header_bytes, cfg.prop_delay_s)
    t0 = tl4.t0
    m = t0.size
    wire = tl4.wire
    link_bps = trace.link_gbps * 1e9
    b_n = len(archs)
    if m == 0:
        return [_empty_result(hw) for hw in hw_list]

    svc = np.empty((b_n, m), np.float64)
    pipe = np.empty(b_n, np.float64)
    depth = np.empty(b_n, np.int64)
    for b, (arch, hw) in enumerate(zip(archs, hw_list)):
        svc[b], pipe[b] = service_times(arch, hw, wire, link_bps)
        depth[b] = arch.voq_depth

    order = tl4.order                          # == the heap's (time, pkt) order
    now = tl4.now
    # ring modulus: a queue never holds more than min(depth, m) packets; the
    # ring size rounds up to a power of two, as in the JAX package
    mod = np.minimum(np.maximum(depth, 1), m).astype(np.int32)
    d_max = 1 << int(int(mod.max()) - 1).bit_length()
    end, admit = _verify_engine(
        _on(now, np.float64, device), _on(tl4.src_o, np.int32, device),
        _on(tl4.dst_o, np.int32, device), _on(svc[:, order], np.float64, device),
        _on(pipe, np.float64, device), _on(depth.astype(np.int32), np.int32, device),
        _on(mod, np.int32, device), n_ports=n, d_max=d_max)
    end = end.cpu().numpy()
    admit = admit.cpu().numpy()

    # one batched sort replaces the per-candidate np.sort the shared-cap
    # check used to run inside the loop below
    sorted_ends = _sorted_admitted_ends(
        end, admit,
        [b for b in range(b_n)
         if archs[b].voq is VOQKind.SHARED and int(depth[b]) >= 1])
    out: List[VerifyResult] = []
    for b, (arch, bound, hw) in enumerate(zip(archs, bounds, hw_list)):
        fallback = None
        if int(depth[b]) < 1:
            # degenerate depth<=0: serial semantics drop every packet; the
            # scan's ring check can't express an always-full queue
            fallback = "degenerate_depth"
        elif arch.voq is VOQKind.SHARED and not _shared_cap_ok(
                admit[b], sorted_ends[b], now, n * int(depth[b])):
            # the global cap binds for this candidate: the per-queue-only scan
            # diverges
            fallback = "shared_cap"
        if fallback is not None:
            # replay through the exact serial oracle, flagged for honesty
            v = run_netsim(arch, bound, trace, hw=hw, cfg=cfg)
            v.meta["shared_cap_fallback"] = fallback == "shared_cap"
            v.meta["fallback"] = fallback
            out.append(v)
            continue
        out.append(_metrics_result(end[b], admit[b], order, t0, tl4.wire_e,
                                   tl4.t0_min, cfg, hw, m))
    return out


def _run_group_kernel(archs, bounds, trace, hw_list, cfg,
                      device) -> List[VerifyResult]:
    """The segmented-kernel engine.

    Runs the speculative fixed point (``kernels.netsim.netsim_fixed_point``)
    on ``device``: one lean port replay fused with an all-admitted fullness
    check settles the whole batch in a single round when stage-3 sizing
    holds, and only dropping rows iterate.  Identical dynamics rows —
    NSGA-II batches repeat genomes — collapse to one scan row and fan back
    out afterwards.  Departure times, admission flags and every reduced
    metric are bit-identical to the serial model (same float64 arithmetic
    in the same order); rows the fixed point cannot settle exactly
    (degenerate depth, binding shared cap, no convergence) take the serial
    oracle, flagged in ``meta["fallback"]``."""
    n = archs[0].n_ports
    tl4 = stage4_timeline(trace, n, bounds[0].header_bytes, cfg.prop_delay_s)
    m = tl4.now.size
    b_n = len(archs)
    if m == 0:
        return [_empty_result(hw) for hw in hw_list]
    link_bps = trace.link_gbps * 1e9
    order, now, t0 = tl4.order, tl4.now, tl4.t0

    svc_e = np.empty((b_n, m), np.float64)      # event order (pre-permuted)
    pipe = np.empty(b_n, np.float64)
    depth = np.empty(b_n, np.int64)
    for b, (arch, hw) in enumerate(zip(archs, hw_list)):
        s, pipe[b] = service_times(arch, hw, tl4.wire, link_bps)
        svc_e[b] = s[order]
        depth[b] = arch.voq_depth

    out: List[Optional[VerifyResult]] = [None] * b_n
    fall: Dict[int, str] = {}
    # candidate dedup: rows with identical (service times, pipe, depth, VOQ
    # kind) have identical dynamics — one scan row serves them all
    slot_of: Dict[Tuple, int] = {}
    uniq_rows: List[int] = []
    rep = np.full(b_n, -1, np.int64)
    for b in range(b_n):
        if int(depth[b]) < 1:
            fall[b] = "degenerate_depth"
            continue
        key = (svc_e[b].tobytes(), float(pipe[b]), int(depth[b]),
               archs[b].voq is VOQKind.SHARED)
        slot = slot_of.setdefault(key, len(uniq_rows))
        if slot == len(uniq_rows):
            uniq_rows.append(b)
        rep[b] = slot

    uniq_res: List[Optional[VerifyResult]] = []
    if uniq_rows:
        ui = np.asarray(uniq_rows)
        end, admit, conv, _rounds = netsim_fixed_point(
            now, tl4.src_o.astype(np.int32), tl4.dst_o.astype(np.int32),
            svc_e[ui], pipe[ui], depth[ui], n_ports=n, chain=tl4.chain,
            device=device)
        sorted_ends = _sorted_admitted_ends(
            end, admit,
            [i for i, b in enumerate(uniq_rows)
             if archs[b].voq is VOQKind.SHARED and bool(conv[i])])
        for i, b in enumerate(uniq_rows):
            if not bool(conv[i]):
                uniq_res.append(None)
                fall[b] = "kernel_unconverged"
                continue
            if archs[b].voq is VOQKind.SHARED and not _shared_cap_ok(
                    admit[i], sorted_ends[i], now, n * int(depth[b])):
                uniq_res.append(None)
                fall[b] = "shared_cap"
                continue
            uniq_res.append(_metrics_result(
                end[i], admit[i], order, t0, tl4.wire_e, tl4.t0_min, cfg,
                hw_list[b], m))

    for b in range(b_n):
        slot = int(rep[b])
        if slot >= 0 and uniq_res[slot] is not None:
            v = uniq_res[slot]
            # duplicates share the (read-only by convention) arrays but get
            # fresh meta dicts — callers annotate meta in place
            out[b] = dataclasses.replace(
                v, meta={**v.meta, "hw": hw_list[b]})
        else:
            # the fixed point defers to the serial oracle, flagged exactly
            # like the default path
            fb = fall.get(b) or fall.get(uniq_rows[slot], "kernel_unconverged")
            v = run_netsim(archs[b], bounds[b], trace, hw=hw_list[b], cfg=cfg)
            v.meta["shared_cap_fallback"] = fb == "shared_cap"
            v.meta["fallback"] = fb
            out[b] = v
    return out


def run_netsim_batched(
    archs: Sequence[SwitchArch],
    bound: Union[BoundProtocol, Sequence[BoundProtocol]],
    trace,
    *,
    hw: Optional[Sequence[HardwareParams]] = None,
    cfg: Optional[NetSimConfig] = None,
    back_annotation: bool = True,
    i_burst: float = 1.0,
    use_kernel=False,
    device=None,
) -> List[VerifyResult]:
    """Verify a whole sized-candidate batch against one shared trace.

    Results are index-aligned with ``archs`` and, candidate by candidate,
    bit-identical to ``run_netsim`` (same drop counts, same delivered set,
    same latency array).  ``bound`` is one ``BoundProtocol`` or a per-
    candidate sequence (the co-design DSE's mixed header widths); candidates
    may mix every architectural policy and any sized VOQ depth.  ``n_ports``
    and header wire-bytes are structural (the event timeline depends on
    both), so mixed batches are partitioned internally by
    ``(n_ports, header_bytes)`` and stitched back in input order.

    ``use_kernel`` selects the segmented-kernel engine (``"auto"``/``"on"``/
    ``"off"`` or a bool; auto = on unless ``SPAC_NETSIM_KERNEL=off``): the
    speculative fixed point of ``repro_torch.kernels.netsim`` replaces the
    ring scan, bit-identical per candidate.  The default is the ring scan,
    as in the JAX package; its ``[B, N², min(max_depth, m)]`` float64 ring
    runs in chunks of rows under ``kernels.ring_scan.RING_BUDGET_BYTES``.

    ``device`` (default: the first CUDA device; raises without one) is where
    the engine runs: the hand-written CUDA kernels on a card, their plain
    PyTorch versions for ``device="cpu"``.
    """
    if cfg is None:
        cfg = NetSimConfig()
    device = resolve_device(device)
    archs = list(archs)
    bounds = (list(bound) if isinstance(bound, (list, tuple))
              else [bound] * len(archs))
    if len(bounds) != len(archs):
        raise ValueError(f"bound has {len(bounds)} entries for {len(archs)} "
                         "archs; they must be index-aligned")
    if cfg.retransmit and any(b.has("seq_no") for b in bounds):
        raise NotImplementedError(
            "driver-level retransmission inserts events dynamically; "
            "fall back to the serial run_netsim for retransmitting configs")
    if not archs:
        return []
    if hw is None:
        source = "cycle_sim" if back_annotation else "model"
        hw = [annotate(a, b, source=source, i_burst=i_burst, device=device)
              for a, b in zip(archs, bounds)]
    hw = list(hw)
    if len(hw) != len(archs):
        raise ValueError(f"hw has {len(hw)} entries for {len(archs)} archs; "
                         "they must be index-aligned")

    runner = (_run_group_kernel if resolve_use_kernel(use_kernel)
              else _run_group)
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, a in enumerate(archs):
        groups.setdefault((a.n_ports, bounds[i].header_bytes), []).append(i)
    if len(groups) == 1:
        return runner(archs, bounds, trace, hw, cfg, device)
    out: List[Optional[VerifyResult]] = [None] * len(archs)
    for idx in groups.values():
        part = runner([archs[i] for i in idx], [bounds[i] for i in idx],
                      trace, [hw[i] for i in idx], cfg, device)
        for i, v in zip(idx, part):
            out[i] = v
    return out
