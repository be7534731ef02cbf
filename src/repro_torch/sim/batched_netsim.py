"""Batched stage-4 verifier (§IV-A.1 at fan-out scale).

``run_netsim`` replays the event-driven, finite-buffer switch model one
candidate at a time through a Python heapq loop.  This module verifies a
whole sized-candidate batch against the *shared* event timeline, with every
per-candidate parameter — bus width, η, pipeline/arbitration cycles, ingress
stalls, f_clk and the stage-3 **sized VOQ depths** — as a batch axis.

The engine is the JAX package's segmented-kernel path
(``use_kernel="auto"``, its default): the speculative fixed point of
``repro_torch.kernels.netsim``.  Round 1 replays every row with all packets
admitted (the hand-written CUDA kernel on the card) and checks on the
device whether any VOQ would have been full; rows that dropped iterate a
gated replay against host-side segmented admission until they close.  The
JAX package's other engine, the ``[B, N², D]`` ring scan selected by
``use_kernel="off"``, is not ported yet and raises here.

``VOQKind.SHARED`` adds a global cap (``N·depth`` packets in flight across
the whole buffer) whose count is *not* FIFO across queues, so it is settled
exactly in a second, host-side pass: the replay runs unconstrained by the
cap, then for each shared candidate the in-flight timeline ``G(t_k) =
admitted-before-k − #(ends ≤ t_k)`` is reconstructed vectorially (one sort +
searchsorted).  If the cap was never reached at an admitted event, the
unconstrained run *is* the constrained run and the batched result is exact;
the rare candidates whose cap does bind fall back to the serial heapq
oracle — exact by definition, and flagged in ``meta["shared_cap_fallback"]``
so throughput reports stay honest.

The replay runs in float64 and shares ``service_times`` /
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

from repro_torch.core.archspec import SwitchArch, VOQKind
from repro_torch.core.binding import BoundProtocol
from repro_torch.core.dse import VerifyResult
from repro_torch.device import resolve_device
from repro_torch.kernels.netsim import netsim_fixed_point, resolve_use_kernel

from .backannotate import HardwareParams, annotate
from .netsim import NetSimConfig, run_netsim, service_times
from .timeline import stage4_timeline

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
    use_kernel="auto",
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

    ``use_kernel`` (``"auto"``/``"on"``/``"off"`` or a bool; auto = on unless
    ``SPAC_NETSIM_KERNEL=off``) must resolve to on: the segmented-kernel
    engine is the one this package has.  The ring-scan engine ``off``
    selects is not ported yet and raises ``NotImplementedError``.

    ``device`` (default: the first CUDA device; raises without one) is where
    the replay runs: the hand-written CUDA kernel on a card, its plain
    PyTorch version for ``device="cpu"``.
    """
    if cfg is None:
        cfg = NetSimConfig()
    if not resolve_use_kernel(use_kernel):
        raise NotImplementedError(
            "use_kernel resolving to off selects the [B, N^2, D] ring-scan "
            "engine, which is not ported to repro_torch yet (ROADMAP queue 2); "
            "use use_kernel='auto' or 'on' (and unset SPAC_NETSIM_KERNEL=off)")
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
        hw = [annotate(a, b, source=source, i_burst=i_burst)
              for a, b in zip(archs, bounds)]
    hw = list(hw)
    if len(hw) != len(archs):
        raise ValueError(f"hw has {len(hw)} entries for {len(archs)} archs; "
                         "they must be index-aligned")

    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, a in enumerate(archs):
        groups.setdefault((a.n_ports, bounds[i].header_bytes), []).append(i)
    if len(groups) == 1:
        return _run_group_kernel(archs, bounds, trace, hw, cfg, device)
    out: List[Optional[VerifyResult]] = [None] * len(archs)
    for idx in groups.values():
        part = _run_group_kernel([archs[i] for i in idx],
                                 [bounds[i] for i in idx], trace,
                                 [hw[i] for i in idx], cfg, device)
        for i, v in zip(idx, part):
            out[i] = v
    return out
