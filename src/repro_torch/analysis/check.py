"""``check``: spec-level static diagnostics — stage 1 as a user-facing pass.

The port's copy of the JAX package's ``analysis/check.py``, over the
port's ``core``, ``traces`` and ``sim.resources``; same codes, same
messages.

The DSE's first stage prunes statically infeasible points before any
simulation (PAPER §IV); this module promotes the same rules (plus the SLA
and budget sanity the stages only discover mid-run) to a standalone check
that needs **no trace and no kernel launch**: everything here is closed-form —
protocol build + semantic binding, ``address_width_error``, the calibrated
resource model (``repro_torch.sim.resources.synthesize``), and per-field layout
feasibility (``ProtocolSpace.feasible``).

Codes (the table in ``docs/architecture.md`` mirrors this):

  * ``SPAC100`` error — the spec does not build/bind at all (unknown
    builder params, unbindable protocol, broken trace generator name).
  * ``SPAC101`` error — an address field cannot address ``n_ports``
    (the rule ``_validate_addressing`` would raise mid-build, surfaced
    up front with a fix hint).
  * ``SPAC102`` error — the SLA is unsatisfiable against the analytic
    lower bound: p99 below the fastest pipeline + header wire time, or a
    throughput floor above what any bus/link can carry.
  * ``SPAC103`` error — the ``ResourceBudget`` is below the *minimal*
    resource plan (cheapest candidate at depth 1, per budget key);
    warning for budget keys the resource model never produces.
  * ``SPAC104`` error/warning — dead co-design gene (a searchable width
    whose every choice is statically infeasible) / inert search dimension
    (a gene the decode canonicalises away, wasting genome bits).
  * ``SPAC105`` info/error — co-design space size and statically feasible
    layout fraction; error when zero layouts survive.
  * ``SPAC106`` error — fabric topology addressability: the routing field
    must address the *fabric host count* (not one switch's ``n_ports``),
    every tier's port count must match the topology's degree, and the
    trace must emit fabric host ids.

Comm-domain scenarios get the spec-shape checks only (their fabric model
has no port-addressing or FPGA-resource analogue), so every registry
scenario — switch and comm — must come back clean.
"""

from __future__ import annotations

import inspect
import itertools
import math
from typing import Dict, List, Optional

from .diagnostics import Diagnostic

__all__ = ["check_scenario", "SPEC_CODES"]

#: code -> one-line description (docs + ``spac check --list-codes``)
SPEC_CODES = {
    "SPAC100": "scenario spec fails to build or bind statically",
    "SPAC101": "address field cannot address n_ports",
    "SPAC102": "SLA unsatisfiable against the analytic lower bound",
    "SPAC103": "resource budget below the minimal resource plan",
    "SPAC104": "dead co-design gene / inert search dimension",
    "SPAC105": "co-design space size and feasible-fraction estimate",
    "SPAC106": "fabric topology addressability / tier-degree mismatch",
}

#: full enumeration of the layout space is capped here; larger spaces get
#: size-only SPAC105 info plus the per-field (local) dead-gene analysis
_ENUM_CAP = 20_000


# --------------------------------------------------------------------------
# shared closed-form ingredients
# --------------------------------------------------------------------------

def _link_gbps(scenario) -> Optional[float]:
    """Link rate without building the trace: explicit param, else the
    generator signature's default.  ``None`` (file-backed or unknown
    generator) makes the wire-time term 0 — the bound stays conservative."""
    spec = scenario.trace
    if spec.generator is None:
        return None
    v = spec.params.get("link_gbps")
    if v is not None:
        return float(v)
    from repro_torch.traces.workloads import WORKLOADS
    gen = WORKLOADS.get(spec.generator)
    if gen is None:
        return None
    p = inspect.signature(gen).parameters.get("link_gbps")
    if p is None or p.default is inspect.Parameter.empty:
        return None
    return float(p.default)


def _min_reports(scenario, bound):
    """Cheapest closed-form resource/timing report per candidate template:
    every ``enumerate_candidates`` point at depth 1 (resources are monotone
    in depth, so each per-key minimum is a valid lower bound)."""
    from repro_torch.core.archspec import enumerate_candidates
    from repro_torch.sim.resources import synthesize
    return [synthesize(a.with_depth(1), bound)
            for a in enumerate_candidates(scenario.arch)]


# --------------------------------------------------------------------------
# the individual checks (switch domain)
# --------------------------------------------------------------------------

def _check_addressing_point(scenario, bound) -> List[Diagnostic]:
    from repro_torch.core.dsl import address_width_error
    out = []
    n = scenario.arch.n_ports
    need = max(1, (n - 1).bit_length())
    for sem in ("routing_key", "src_key"):
        if not bound.has(sem):
            continue
        f = bound.protocol.field(bound.semantics[sem])
        err = address_width_error(sem, f.name, f.bits, n)
        if err is not None:
            out.append(Diagnostic(
                "SPAC101", "error", err, f"protocol.{f.name}",
                hint=f"widen {f.name!r} to >= {need} bits (or reduce "
                     f"arch.n_ports); the run would fail at build time "
                     f"with this same rule"))
    return out


def _check_space_genes(scenario, space) -> List[Diagnostic]:
    """Per-field dead-choice analysis — local, so it works at any space size."""
    from repro_torch.core.dsl import address_width_error
    out = []
    n = scenario.arch.n_ports
    for f in space.fields:
        if f.semantic not in ("routing_key", "src_key"):
            continue
        live, dead = [], []
        for b in f.bits:
            if b == 0:
                # a dropped src is legal; a dropped routing key is not
                (dead if f.semantic == "routing_key" else live).append(b)
            elif address_width_error(f.semantic, f.name, b, n) is None:
                live.append(b)
            else:
                dead.append(b)
        loc = f"protocol.{f.name}"
        if not live:
            out.append(Diagnostic(
                "SPAC104", "error",
                f"dead co-design gene: no width choice of {f.semantic} field "
                f"{f.name!r} ({f.bits}) can address n_ports={n}",
                loc,
                hint=f"add a choice >= {max(1, (n - 1).bit_length())} bits "
                     f"to the {f.name!r} menu — every genome decodes "
                     f"statically infeasible"))
        elif len(f.bits) > 1 and len(live) == 1:
            out.append(Diagnostic(
                "SPAC104", "warning",
                f"co-design gene {f.name!r} is effectively pinned: of "
                f"{f.bits} only width {live[0]} survives the static rules "
                f"(dead: {dead})", loc,
                hint="drop the dead choices — they cost genome space and "
                     "search evaluations without adding reachable layouts"))
    return out


def _check_inert_arch_dims(scenario) -> List[Diagnostic]:
    """Genome dimensions ``SwitchDSEProblem.decode`` canonicalises away for
    the pinned policies (only meaningful when a search genome exists)."""
    from repro_torch.core.archspec import (AUTO, ForwardTableKind, SchedulerKind)
    out = []
    req = scenario.arch
    sched_opts = list(SchedulerKind) if req.sched is AUTO else [req.sched]
    fwd_opts = [
        f for f in (list(ForwardTableKind) if req.fwd is AUTO else [req.fwd])
        if not (f is ForwardTableKind.FULL_LOOKUP and req.addr_bits > 16)
    ] or [ForwardTableKind.MULTIBANK_HASH]
    if SchedulerKind.ISLIP not in sched_opts:
        out.append(Diagnostic(
            "SPAC104", "warning",
            f"islip_iters gene is inert: scheduler pinned to "
            f"{[s.value for s in sched_opts]} so decode() canonicalises "
            f"every iteration count to the default", "arch.sched",
            hint="pin sched to AUTO (or include islip) to make the gene "
                 "live, or accept the wasted genome dimension"))
    if ForwardTableKind.MULTIBANK_HASH not in fwd_opts:
        out.append(Diagnostic(
            "SPAC104", "warning",
            "hash_banks/hash_depth genes are inert: forwarding pinned to "
            "full_lookup so banking genes never reach the decoded "
            "architecture", "arch.fwd",
            hint="pin fwd to AUTO (or multibank_hash) to make the banking "
                 "genes live"))
    return out


def _check_space_fraction(scenario, space) -> List[Diagnostic]:
    total = space.size()
    loc = "protocol"
    if total > _ENUM_CAP:
        return [Diagnostic(
            "SPAC105", "info",
            f"co-design layout space has {total} points (> {_ENUM_CAP}, "
            f"feasible fraction not enumerated)", loc)]
    n = scenario.arch.n_ports
    feasible = sum(
        1 for combo in itertools.product(*(f.bits for f in space.fields))
        if space.feasible(combo, n_ports=n) is None)
    if feasible == 0:
        return [Diagnostic(
            "SPAC105", "error",
            f"0 of {total} protocol layouts are statically feasible — the "
            f"co-design search has nothing to evaluate", loc,
            hint="fix the dead genes reported by SPAC104; feasibility here "
                 "uses the addressing/structure rules only (payload-length "
                 "rules additionally need the built trace)")]
    return [Diagnostic(
        "SPAC105", "info",
        f"{feasible} of {total} protocol layouts statically feasible "
        f"({feasible / total:.0%}); the joint genome adds the architecture "
        f"dimensions on top", loc)]


def _check_topology(scenario, bound, space) -> List[Diagnostic]:
    """SPAC106 — multi-hop fabric shape rules.  Exactly one of ``bound``
    (point protocol) / ``space`` (co-design space) is non-None.

    A topology changes the addressing target: packets carry *fabric host*
    ids end-to-end, so the routing field must cover ``topology.n_hosts``
    even though each individual switch only exposes ``degree`` ports.
    ``_validate_addressing`` in the runner enforces the same rule at build
    time; this surfaces it statically with the topology named."""
    from repro_torch.core.dsl import address_width_error
    out: List[Diagnostic] = []
    topo = scenario.topology.build()
    n = topo.n_hosts
    need = max(1, (n - 1).bit_length())

    if space is not None:
        for f in space.fields:
            if f.semantic != "routing_key":
                continue
            live = [b for b in f.bits if b and address_width_error(
                "routing_key", f.name, b, n) is None]
            if not live:
                out.append(Diagnostic(
                    "SPAC106", "error",
                    f"no width choice of routing field {f.name!r} ({f.bits}) "
                    f"can address the fabric's {n} hosts (topology "
                    f"{topo.kind!r}) — one switch's n_ports="
                    f"{scenario.arch.n_ports} is not the addressing target",
                    f"protocol.{f.name}",
                    hint=f"add a routing width >= {need} bits; multi-hop "
                         f"routes are keyed by destination *host* id"))
    elif bound is not None:
        for sem in ("routing_key", "src_key"):
            if not bound.has(sem):
                continue
            f = bound.protocol.field(bound.semantics[sem])
            if address_width_error(sem, f.name, f.bits, n) is not None:
                out.append(Diagnostic(
                    "SPAC106", "error",
                    f"{sem} field {f.name!r} ({f.bits} bits) cannot address "
                    f"the fabric's {n} hosts (topology {topo.kind!r}); with "
                    f"a topology, addressing is checked against the host "
                    f"count, not one switch's n_ports="
                    f"{scenario.arch.n_ports}",
                    f"protocol.{f.name}",
                    hint=f"widen {f.name!r} to >= {need} bits — endpoints "
                         f"are fabric host ids, so a single switch's port "
                         f"width is not enough"))

    for t, tier in enumerate(topo.tiers):
        if tier.degree != scenario.arch.n_ports:
            out.append(Diagnostic(
                "SPAC106", "error",
                f"tier {t} ({tier.name!r}) of topology {topo.kind!r} has "
                f"degree {tier.degree} but arch.n_ports="
                f"{scenario.arch.n_ports} — every tier's switches must "
                f"expose exactly the topology's per-tier port count",
                "arch.n_ports",
                hint=f"set arch.n_ports={tier.degree}; the fabric problem "
                     f"sizes each tier to its degree and a mismatched "
                     f"template means the addr/policy menu was shaped for "
                     f"the wrong radix"))

    tr = scenario.trace
    tr_ports = None
    if tr.generator is not None:
        tr_ports = tr.params.get("n_ports")
        if tr_ports is None:
            from repro_torch.traces.workloads import WORKLOADS
            gen = WORKLOADS.get(tr.generator)
            if gen is not None:
                p = inspect.signature(gen).parameters.get("n_ports")
                if p is not None and p.default is not inspect.Parameter.empty:
                    tr_ports = p.default
    if tr_ports is not None and int(tr_ports) != n:
        out.append(Diagnostic(
            "SPAC106", "error",
            f"trace generator emits {int(tr_ports)} endpoint ids but "
            f"topology {topo.kind!r} has {n} hosts — multi-hop routing "
            f"needs src/dst in [0, {n})", "trace.n_ports",
            hint=f"set trace params n_ports={n} so packets target fabric "
                 f"hosts"))
    return out


def _check_sla(scenario, bound, min_header_bytes: int) -> List[Diagnostic]:
    out = []
    reports = _min_reports(scenario, bound)
    link = _link_gbps(scenario)
    min_pipe_ns = min(r.latency_ns for r in reports)
    wire_ns = (min_header_bytes * 8 / link) if link else 0.0
    lower = min_pipe_ns + wire_ns
    sla = scenario.sla
    if sla.p99_latency_ns < lower:
        detail = (f"fastest pipeline {min_pipe_ns:.1f} ns"
                  + (f" + {min_header_bytes} B header at {link:g} Gbps "
                     f"= {wire_ns:.1f} ns wire time" if link else ""))
        out.append(Diagnostic(
            "SPAC102", "error",
            f"sla.p99_latency_ns={sla.p99_latency_ns:g} is below the "
            f"analytic lower bound {lower:.1f} ns ({detail}) — no candidate "
            f"can ever satisfy it", "sla.p99_latency_ns",
            hint=f"raise the p99 SLA above ~{lower:.0f} ns or the whole "
                 f"Pareto front will be empty"))
    if sla.min_throughput_gbps > 0:
        max_tp = max(r.max_throughput_gbps for r in reports)
        cap = min(max_tp, link) if link else max_tp
        if sla.min_throughput_gbps > cap:
            which = ("the link rate" if link and link < max_tp
                     else "the widest bus at its fmax")
            out.append(Diagnostic(
                "SPAC102", "error",
                f"sla.min_throughput_gbps={sla.min_throughput_gbps:g} "
                f"exceeds {which} ({cap:.1f} Gbps) — unsatisfiable",
                "sla.min_throughput_gbps",
                hint="lower the throughput floor or raise the trace's "
                     "link_gbps"))
    return out


def _check_budget(scenario, bound) -> List[Diagnostic]:
    out = []
    budget = scenario.budget
    if budget is None:
        from repro_torch.sim.resources import ALVEO_U45N
        limits: Dict[str, float] = dict(ALVEO_U45N)
        origin = "budget (default Alveo U45N)"
    else:
        limits = dict(budget.limits)
        origin = "budget"
    reports = _min_reports(scenario, bound)
    minimal = {
        "luts": min(r.luts for r in reports),
        "ffs": min(r.ffs for r in reports),
        "brams": min(r.brams for r in reports),
    }
    minimal["bram"] = minimal["brams"]       # resources() exposes both keys
    for key, limit in sorted(limits.items()):
        need = minimal.get(key)
        if need is None:
            out.append(Diagnostic(
                "SPAC103", "warning",
                f"budget key {key!r} is not produced by the switch resource "
                f"model (known: {sorted(minimal)}) — the limit can never "
                f"constrain anything", f"{origin}.{key}",
                hint="likely a typo; admits() treats absent usage as 0"))
        elif need > limit:
            out.append(Diagnostic(
                "SPAC103", "error",
                f"{origin[:6]}.{key}={limit:g} is below the minimal plan: "
                f"even the cheapest candidate at depth 1 needs "
                f"{need:,.0f} {key}", f"{origin}.{key}",
                hint=f"raise the {key} limit to at least {need:,.0f} or "
                     f"shrink the request (fewer ports, narrower bus menu)"))
    return out


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def check_scenario(scenario) -> List[Diagnostic]:
    """All static diagnostics for one ``Scenario`` — no trace is built, no
    kernel launches; see the module docstring for the code table."""
    diags: List[Diagnostic] = []

    # trace source sanity is domain-independent and cheap
    if scenario.domain == "switch" and scenario.trace.generator is not None:
        from repro_torch.traces.workloads import WORKLOADS
        if scenario.trace.generator not in WORKLOADS:
            diags.append(Diagnostic(
                "SPAC100", "error",
                f"unknown trace generator {scenario.trace.generator!r} "
                f"(known: {sorted(WORKLOADS)})", "trace.generator"))

    if scenario.domain != "switch":
        # the comm fabric model has no port-addressing / FPGA-resource
        # analogue; its specs are validated structurally by Scenario itself
        return diags

    from repro_torch.core.binding import bind

    if scenario.protocol.is_space:
        try:
            space = scenario.protocol.space()
        except ValueError as e:
            diags.append(Diagnostic("SPAC100", "error", str(e), "protocol"))
            return diags
        diags.extend(_check_space_genes(scenario, space))
        if scenario.search is not None or scenario.co_design:
            diags.extend(_check_inert_arch_dims(scenario))
        diags.extend(_check_space_fraction(scenario, space))
        if scenario.topology is not None:
            diags.extend(_check_topology(scenario, None, space))
        # price the SLA/budget bounds at the widest layout (bindable iff any
        # is) but serialize the *narrowest* feasible header on the wire
        try:
            bound = bind(space.decode(space.max_widths()),
                         scenario.semantic_binding(),
                         flit_bits=scenario.flit_bits)
        except ValueError as e:
            diags.append(Diagnostic(
                "SPAC100", "error",
                f"widest layout of the protocol space does not bind: {e}",
                "protocol"))
            return diags
        min_header_bits = sum(min(f.bits) for f in space.fields)
        min_header_bytes = max(1, -(-min_header_bits // 8))
    else:
        try:
            protocol = scenario.protocol.build()
            bound = bind(protocol, scenario.semantic_binding(),
                         flit_bits=scenario.flit_bits)
        except ValueError as e:
            diags.append(Diagnostic("SPAC100", "error", str(e), "protocol"))
            return diags
        diags.extend(_check_addressing_point(scenario, bound))
        if scenario.topology is not None:
            diags.extend(_check_topology(scenario, bound, None))
        min_header_bytes = bound.protocol.header_bytes

    diags.extend(_check_sla(scenario, bound, min_header_bytes))
    diags.extend(_check_budget(scenario, bound))
    return diags
