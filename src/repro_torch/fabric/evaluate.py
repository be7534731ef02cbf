"""Multi-hop fabric evaluation: thread one trace through a network of
switches using the existing batched stage-2/stage-4 engines.

Two ideas make this exact *and* keep the jit shape story unchanged:

**Super-switch flattening.**  All switches in a tier share one design, and
every piece of engine state — ``in_free``/``out_free`` port availability,
the per-(src, dst) VOQ ring, the host-NIC serialisation — is per-port or
per-port-pair.  So K p-port switches of one tier are simulated as ONE
flattened switch with ``K*p`` ports (``flat = node * degree + local``): one
batched engine call per tier, bit-exactly the K independent switches.  The
single coupling exception is ``VOQKind.SHARED``, whose global ``N*depth``
cap would pool buffers *across* nodes — fabric evaluation rejects it.

**Hop composition via the latency identity.**  Every verify engine reports
``latency[k] = (end + prop_delay - t0[k]) * 1e9`` (now exposed whole-trace in
``meta["latency_full_ns"]``, NaN = dropped), so the arrival time at the next
hop's ingress is exactly ``t0[k] + latency[k]*1e-9 = end + prop_delay``.
Each hop's departures become the next hop's arrivals; each hop re-applies the
ingress serialisation (``switch_arrival_times``) — the documented
store-and-forward contract, identical across the serial, batched and kernel
engines, so composition is engine- and mesh-invariant.

**Drops mask downstream, without changing shapes.**  A packet dropped at hop
s must not appear at hop s+1 — but removing its row would change the event
count and retrigger jit tracing per candidate.  Instead the dead row keeps
flowing with a *sentinel* arrival time strictly after every live packet in
its sub-trace (max live time + 1 s).  Sentinels sort last, so the engines'
forward-in-time state (host serialisation, port availability, VOQ ring)
processes every live packet before any sentinel: live results are provably
unperturbed, and the evaluator simply ignores sentinel rows via its own
``alive`` mask.  Candidates whose upstream histories agree bit-for-bit (hop
0: all of them) share one batched call; later hops group by arrival-array
content, so the fan-out stays batched wherever dynamics coincide.

The port's copy of the JAX package's ``fabric/evaluate.py``: NumPy around
the batched engines, which run on ``device`` (default: the first CUDA
device; ``device="cpu"`` takes the kernels' plain versions), each call's
candidate axis sharded over ``mesh`` when one is given.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.archspec import SwitchArch, VOQKind
from repro_torch.core.dse import SurrogateResult, VerifyResult
from repro_torch.device import resolve_device
from repro_torch.sim.backannotate import annotate
from repro_torch.sim.batched_netsim import run_netsim_batched
from repro_torch.sim.batched_surrogate import run_surrogate_batched
from repro_torch.sim.netsim import NetSimConfig
from repro_torch.sim.timeline import trace_key
from repro_torch.traces import Trace

from .topology import Topology

__all__ = ["FabricRoutes", "evaluate_fabric_batched",
           "surrogate_fabric_batched", "fabric_routes", "flatten_tier_arch"]

#: route-table memo: (trace content, topology) -> FabricRoutes.  Bounded FIFO
#: like ``sim.timeline`` — hop-composition re-enters per generation.
_ROUTE_MEMO: Dict[Tuple[str, str], "FabricRoutes"] = {}
_MAX_ROUTE_MEMO = 16


class FabricRoutes:
    """Precomputed hop tables for one (topology, trace) pair.

    ``n_hops[p]`` is packet p's route length; for stage ``s < n_hops[p]``,
    ``tier_of[s, p]`` / ``flat_in[s, p]`` / ``flat_out[s, p]`` give the tier
    index and the *flattened* super-switch ingress/egress port ids
    (``node * degree + local``).  Stages a packet has already exited carry
    ``-1``."""

    def __init__(self, topo: Topology, src: np.ndarray, dst: np.ndarray):
        m = src.size
        h_max = max(topo.max_hops, 1)
        self.n_hops = np.zeros(m, np.int64)
        self.tier_of = np.full((h_max, m), -1, np.int64)
        self.flat_in = np.full((h_max, m), -1, np.int64)
        self.flat_out = np.full((h_max, m), -1, np.int64)
        degrees = [tier.degree for tier in topo.tiers]
        for p in range(m):
            hops = topo.route(int(src[p]), int(dst[p]))
            self.n_hops[p] = len(hops)
            for s, hop in enumerate(hops):
                d = degrees[hop.tier]
                self.tier_of[s, p] = hop.tier
                self.flat_in[s, p] = hop.node * d + hop.in_port
                self.flat_out[s, p] = hop.node * d + hop.out_port
        self.max_hops = int(self.n_hops.max()) if m else 0


def fabric_routes(topo: Topology, trace) -> FabricRoutes:
    key = (trace_key(trace), topo.key())
    hit = _ROUTE_MEMO.get(key)
    if hit is None:
        hit = FabricRoutes(topo, np.asarray(trace.src), np.asarray(trace.dst))
        _ROUTE_MEMO[key] = hit
        while len(_ROUTE_MEMO) > _MAX_ROUTE_MEMO:
            _ROUTE_MEMO.pop(next(iter(_ROUTE_MEMO)))
    return hit


def flatten_tier_arch(arch: SwitchArch, tier_nodes: int) -> SwitchArch:
    """The tier's per-node template widened to the super-switch port count.
    Everything else — bus width, VOQ depth, scheduler — stays per-node, and
    the per-node ``hw`` is passed to the engines explicitly, so flattening
    changes indexing only, never timing."""
    if arch.voq is VOQKind.SHARED:
        raise ValueError(
            "fabric tiers cannot use VOQKind.SHARED: the shared buffer cap "
            "would pool across nodes once the tier is flattened into a "
            "super-switch (per-node NXN VOQs flatten exactly)")
    return replace(arch, n_ports=arch.n_ports * tier_nodes)


def _check_tiers(topo: Topology, tiers: Sequence[SwitchArch]) -> None:
    if len(tiers) != topo.n_tiers:
        raise ValueError(f"{len(tiers)} tier designs for {topo.n_tiers}-tier "
                         f"{topo.kind}")
    for t, (arch, tier) in enumerate(zip(tiers, topo.tiers)):
        if arch.n_ports != tier.degree:
            raise ValueError(
                f"tier {t} ({tier.name}) arch has n_ports={arch.n_ports} but "
                f"the topology degree is {tier.degree}")


def _sorted_subtrace(name: str, times: np.ndarray, src: np.ndarray,
                     dst: np.ndarray, payload: np.ndarray, n_ports: int,
                     link_gbps: float) -> Tuple[Trace, np.ndarray]:
    """Pre-sorted Trace + the permutation mapping storage order back to the
    caller's packet order.  Sorting here (stable, once per unique arrival
    content) makes ``Trace.__post_init__``'s own stable sort the identity, so
    ``meta["latency_full_ns"]`` row i is the caller's packet ``perm[i]``."""
    perm = np.argsort(times, kind="stable")
    sub = Trace(name=name, time_s=times[perm], src=src[perm].astype(np.int32),
                dst=dst[perm].astype(np.int32),
                payload_bytes=payload[perm], n_ports=n_ports,
                link_gbps=link_gbps)
    return sub, perm


def _tier_hw(cands_archs, cands_bounds, back_annotation: bool,
             i_burst: float, device):
    """Per-candidate per-tier HardwareParams from the *per-node* arch — the
    flattened super-switch must run with per-node timing."""
    source = "cycle_sim" if back_annotation else "model"
    return [tuple(annotate(a, b, source=source, i_burst=i_burst,
                           device=device)
                  for a, b in zip(archs, bounds))
            for archs, bounds in zip(cands_archs, cands_bounds)]


def _masked_times(arr_row: np.ndarray, alive_row: np.ndarray) -> np.ndarray:
    """Arrival times with dead packets pushed to a sentinel strictly after
    every live packet (max live time + 1 s), keeping the event count fixed."""
    times = arr_row.copy()
    if not alive_row.all():
        live = times[alive_row]
        base = float(live.max()) if live.size else 0.0
        times[~alive_row] = base + 1.0
    return times


def evaluate_fabric_batched(
    topo: Topology,
    cands_archs: Sequence[Sequence[SwitchArch]],
    cands_bounds: Sequence[Sequence],
    trace,
    *,
    hw: Optional[Sequence[Sequence]] = None,
    cfg: Optional[NetSimConfig] = None,
    back_annotation: bool = True,
    i_burst: float = 1.0,
    mesh=None,
    use_kernel=False,
    device=None,
) -> List[VerifyResult]:
    """Stage-4 verify for a batch of fabric candidates.

    ``cands_archs[b][t]`` / ``cands_bounds[b][t]`` are candidate b's per-node
    design for tier t (``n_ports`` == the tier's degree).  Results are
    index-aligned, row-independent (grouping never changes a candidate's
    numbers — each batched engine call is per-candidate exact), and
    mesh/engine-invariant, so serve-path chunking and the device mesh compose
    unchanged.  ``device`` is where the engines run (default: the first CUDA
    device)."""
    device = resolve_device(device)
    if cfg is None:
        cfg = NetSimConfig()
    cands_archs = [tuple(a) for a in cands_archs]
    cands_bounds = [tuple(b) for b in cands_bounds]
    n_cands = len(cands_archs)
    if n_cands == 0:
        return []
    for archs in cands_archs:
        _check_tiers(topo, archs)
    if hw is None:
        hw = _tier_hw(cands_archs, cands_bounds, back_annotation, i_burst,
                      device)
    hw = [tuple(h) for h in hw]

    t0 = np.asarray(trace.time_s, np.float64)
    payload = np.asarray(trace.payload_bytes, np.int64)
    m = t0.size
    routes = fabric_routes(topo, trace)
    flat_archs = [tuple(flatten_tier_arch(a, tier.n_nodes)
                        for a, tier in zip(archs, topo.tiers))
                  for archs in cands_archs]

    arr = np.tile(t0, (n_cands, 1))            # current arrival per candidate
    # end-to-end latency accumulates as the ns-sum of per-hop latencies
    # (telescoping: each hop measures end+prop minus its own ingress time),
    # so a 1-hop fabric is bit-identical to the direct single-switch call
    e2e = np.zeros((n_cands, m))
    alive = np.ones((n_cands, m), bool)
    tier_drops = np.zeros((n_cands, topo.n_tiers), np.int64)

    for s in range(routes.max_hops):
        for t in range(topo.n_tiers):
            sel = np.nonzero(routes.tier_of[s] == t)[0]
            if sel.size == 0:
                continue
            tier = topo.tiers[t]
            n_flat = tier.n_nodes * tier.degree
            fin = routes.flat_in[s, sel]
            fout = routes.flat_out[s, sel]
            pay = payload[sel]
            # group candidates whose upstream histories agree bit-for-bit —
            # hop 0 is always one group, later hops share calls whenever
            # dynamics coincided upstream
            groups: Dict[bytes, List[int]] = {}
            times_rows = []
            for b in range(n_cands):
                row = _masked_times(arr[b, sel], alive[b, sel])
                times_rows.append(row)
                groups.setdefault(row.tobytes(), []).append(b)
            for members in groups.values():
                sub, perm = _sorted_subtrace(
                    f"{trace.name}@h{s}t{t}", times_rows[members[0]],
                    fin, fout, pay, n_flat, trace.link_gbps)
                res = run_netsim_batched(
                    [flat_archs[b][t] for b in members],
                    [cands_bounds[b][t] for b in members],
                    sub, hw=[hw[b][t] for b in members], cfg=cfg,
                    back_annotation=back_annotation, i_burst=i_burst,
                    mesh=mesh, use_kernel=use_kernel, device=device)
                for b, v in zip(members, res):
                    lat_pkt = np.empty(sel.size, np.float64)
                    lat_pkt[perm] = v.meta["latency_full_ns"]
                    was = alive[b, sel]
                    ok = was & ~np.isnan(lat_pkt)
                    arr[b, sel] = np.where(ok, arr[b, sel] + lat_pkt * 1e-9,
                                           arr[b, sel])
                    e2e[b, sel] = np.where(ok, e2e[b, sel] + lat_pkt,
                                           e2e[b, sel])
                    tier_drops[b, t] += int((was & ~ok).sum())
                    alive[b, sel] = ok

    # per-packet wire bytes at the final hop (what lands on the host's link)
    last = np.maximum(routes.n_hops - 1, 0)
    last_tier = routes.tier_of[last, np.arange(m)] if m else np.zeros(0, np.int64)
    t0_min = float(t0.min()) if m else 0.0

    out: List[VerifyResult] = []
    for b in range(n_cands):
        ok = alive[b]
        lat = e2e[b, ok]
        headers = np.array([cands_bounds[b][t].header_bytes
                            for t in range(topo.n_tiers)], np.int64)
        delivered_bits = float(((payload[ok] + headers[last_tier[ok]]) * 8).sum())
        t_end = float((arr[b, ok] - cfg.prop_delay_s).max()) if ok.any() else 0.0
        duration = max(t_end - t0_min, 1e-12)
        hops_ok = routes.n_hops[ok]
        out.append(VerifyResult(
            p99_latency_ns=float(np.percentile(lat, 99)) if lat.size else math.inf,
            mean_latency_ns=float(lat.mean()) if lat.size else math.inf,
            drop_rate=int((~ok).sum()) / max(m, 1),
            throughput_gbps=delivered_bits / duration / 1e9,
            meta={
                "latency_ns": lat,
                "latency_full_ns": np.where(ok, e2e[b], np.nan),
                "delivered": int(ok.sum()), "offered": int(m),
                "hw": hw[b], "engine": "fabric_netsim",
                "fabric": {
                    "p50_latency_ns": float(np.percentile(lat, 50)) if lat.size else math.inf,
                    "max_hops": int(routes.max_hops),
                    "mean_hops": float(hops_ok.mean()) if hops_ok.size else 0.0,
                    "per_tier_drops": [int(x) for x in tier_drops[b]],
                },
            }))
    return out


def surrogate_fabric_batched(
    topo: Topology,
    cands_archs: Sequence[Sequence[SwitchArch]],
    cands_bounds: Sequence[Sequence],
    trace,
    *,
    back_annotation: bool = False,
    i_burst: float = 1.0,
    mesh=None,
    use_kernel=False,
    device=None,
) -> List[SurrogateResult]:
    """Stage-2 screen for fabric candidates: one batched surrogate call per
    tier over that tier's *merged traversal trace* (every hop through the
    tier, at the packets' original injection times — candidate-independent,
    so the whole batch shares each tier's timeline and occupancy shapes).

    Per candidate the tier results combine into one fabric-level
    ``SurrogateResult``: end-to-end latency is the per-packet *sum* of its
    hop latencies (a screening proxy; stage 4 is authoritative), occupancy is
    a ``[n_tiers, max_len]`` NaN-padded stack — row t sizes tier t's buffers
    in ``FabricDSEProblem.size_buffers`` — and throughput is the bottleneck
    tier's.  ``device`` is where the engine runs (default: the first CUDA
    device)."""
    device = resolve_device(device)
    cands_archs = [tuple(a) for a in cands_archs]
    cands_bounds = [tuple(b) for b in cands_bounds]
    n_cands = len(cands_archs)
    if n_cands == 0:
        return []
    for archs in cands_archs:
        _check_tiers(topo, archs)
    hw = _tier_hw(cands_archs, cands_bounds, back_annotation, i_burst, device)

    t0 = np.asarray(trace.time_s, np.float64)
    payload = np.asarray(trace.payload_bytes, np.int64)
    m = t0.size
    routes = fabric_routes(topo, trace)

    e2e = np.zeros((n_cands, m))
    tier_occ: List[Optional[np.ndarray]] = [None] * topo.n_tiers  # [B, m_t]
    tier_tput = np.full((n_cands, topo.n_tiers), np.inf)
    for t in range(topo.n_tiers):
        stage_idx, pkt_idx = np.nonzero(routes.tier_of == t)
        if pkt_idx.size == 0:
            continue
        tier = topo.tiers[t]
        n_flat = tier.n_nodes * tier.degree
        sub, perm = _sorted_subtrace(
            f"{trace.name}@tier{t}", t0[pkt_idx],
            routes.flat_in[stage_idx, pkt_idx],
            routes.flat_out[stage_idx, pkt_idx],
            payload[pkt_idx], n_flat, trace.link_gbps)
        res = run_surrogate_batched(
            [flatten_tier_arch(cands_archs[b][t], tier.n_nodes)
             for b in range(n_cands)],
            [cands_bounds[b][t] for b in range(n_cands)],
            sub, hw=[hw[b][t] for b in range(n_cands)],
            back_annotation=back_annotation, i_burst=i_burst,
            mesh=mesh, use_kernel=use_kernel, device=device).results()
        occ = np.empty((n_cands, pkt_idx.size))
        for b, sr in enumerate(res):
            lat_trav = np.empty(pkt_idx.size, np.float64)
            lat_trav[perm] = np.asarray(sr.latency_ns, np.float64)
            np.add.at(e2e[b], pkt_idx, lat_trav)
            q = np.empty(pkt_idx.size, np.float64)
            q[perm] = np.asarray(sr.q_occupancy, np.float64)
            occ[b] = q
            tier_tput[b, t] = sr.throughput_gbps
        tier_occ[t] = occ

    max_len = max((o.shape[1] for o in tier_occ if o is not None), default=1)
    out: List[SurrogateResult] = []
    for b in range(n_cands):
        stack = np.full((topo.n_tiers, max_len), np.nan)
        for t, o in enumerate(tier_occ):
            if o is not None:
                stack[t, :o.shape[1]] = o[b]
        tput = tier_tput[b][np.isfinite(tier_tput[b])]
        out.append(SurrogateResult(
            q_occupancy=stack,
            latency_ns=e2e[b],
            throughput_gbps=float(tput.min()) if tput.size else 0.0,
            meta={"engine": "fabric_surrogate", "batched": True,
                  "n_tiers": topo.n_tiers, "max_hops": int(routes.max_hops)}))
    return out
