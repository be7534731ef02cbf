"""``python -m repro_torch serve`` — DSE as a continuously-batched,
content-cached service (the port's copy of the JAX package's
``api/service.py``).

Every ``run`` pays trace build, layout bind and back-annotation from
scratch; this module keeps them alive.  :class:`DSEServeEngine` is a
long-running engine on the same slot-array discipline as the token server
(:class:`repro_torch.serve.slots.SlotArray`): scenario requests wait in a
FIFO queue, occupy one of ``slots`` fixed slots, and each slot's
Algorithm-1 state is an :class:`repro_torch.core.dse.IncrementalDSE`.  Each tick the engine drains every
active slot's pending candidate rows — stage-2 surrogate rows and stage-4
verify rows — into **fixed-width chunks** (``batch_width`` / ``verify_width``
rows, padded by repeating the final row) fanned through the shared problem's
batched engines, so the stage-2 kernel launches at one width as requests
come and go (stage 4's fixed point runs a chunk's distinct rows, as the JAX
package's does: at most ``verify_width``); ``repro_torch.analysis.retrace``
shows it: a second wave of requests at the same widths adds no call key.  Requests sharing a problem share one chunk
(the campaign runner's cross-scenario batching, made continuous).

Chunking and padding are exact, not approximate: both batch hooks are
row-independent (the invariant ``run_campaign`` already relies on), so a
served report is identical to ``run_scenario`` on the same scenario —
including under ``use_kernel="on"`` — modulo the volatile ``*_time_s``
keys (``strip_times`` removes them for comparison).

Three content-addressed caches make repeat traffic O(lookup):

* **report cache** — canonical scenario JSON (seed folded into the trace
  params, mesh stripped: reports are mesh-invariant) → the golden-format
  report dict.  A repeat request is answered at admission without touching
  a simulator.
* **trace cache** — ``TraceSpec.key()`` → (built trace, feature analysis);
  downstream, ``repro_torch.sim.timeline`` memoises per-trace event orderings by
  content hash, so even a fresh problem on a cached trace never re-sorts.
* **problem cache** — the scenario's structural subset (arch, protocol,
  binding, trace, fidelity engines) → a live ``DSEProblem``.  Problems carry
  the ``layout_key``-memoized ``bind`` cache, so co-design requests re-use
  every previously compiled ``ParserPlan``.

The engine runs on ``device`` (the card by default, raising without one;
``device="cpu"`` runs the kernels' plain versions), every chunk sharded
over ``mesh`` when one is given (reports stay bit-identical).  A request
whose spec cannot build fails alone, with its error recorded; a kernel that
fails to build or launch (``kernels.build.KernelError``) stops the service
instead of becoming a request error.

Hit/miss counters for all three (plus chunk/pad accounting and the timeline
memo counters) surface in ``stats()`` and ride the CLI/benchmark reports.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch

from repro_torch.core.dse import IncrementalDSE
from repro_torch.device import resolve_device
from repro_torch.kernels.build import KernelError
from repro_torch.serve.slots import SlotArray

from .registry import registry
from .runner import ScenarioReport, build_problem
from .scenario import MeshSpec, Scenario

__all__ = ["ServeRequest", "DSEServeEngine", "Client", "request_key",
           "strip_times"]

#: faults of the machine or the port, never of one request: they propagate
_DEVICE_FAULTS = (KernelError, torch.cuda.OutOfMemoryError,
                  getattr(torch, "AcceleratorError", KernelError))

#: bounded cache sizes (oldest-entry eviction) — a long-lived service must
#: not accumulate reports/traces without bound
_MAX_REPORTS = 512
_MAX_TRACES = 32
_MAX_PROBLEMS = 64


def _evict(cache: Dict, limit: int) -> None:
    while len(cache) > limit:
        cache.pop(next(iter(cache)))


def strip_times(obj):
    """Recursively drop the volatile ``*_time_s`` keys from a report dict —
    what remains is the deterministic payload two runs must agree on."""
    if isinstance(obj, dict):
        return {k: strip_times(v) for k, v in obj.items()
                if not k.endswith("_time_s")}
    if isinstance(obj, list):
        return [strip_times(v) for v in obj]
    return obj


def request_key(scenario: Scenario) -> str:
    """Content-addressed report-cache key: the canonical scenario JSON with
    the mesh stripped (reports are mesh-invariant, so the same scenario
    served on 1 or 8 devices is one cache line).  The trace seed lives in
    the trace params, so ``(scenario, seed)`` keys are distinct."""
    d = scenario.to_dict()
    d.pop("mesh", None)
    return json.dumps(d, sort_keys=True)


def _problem_key(scenario: Scenario) -> str:
    """Problems are shared across requests agreeing on everything the
    ``DSEProblem`` constructor consumes (SLA/budget/top-k/delta are per-run
    arguments, not problem state)."""
    fid = scenario.fidelity
    d = scenario.to_dict()
    return json.dumps({
        "domain": scenario.domain,
        "arch": d.get("arch"),
        "comm": d.get("comm"),
        "protocol": d.get("protocol"),
        "flit_bits": scenario.flit_bits,
        "binding": d.get("binding"),
        "trace": d.get("trace"),
        "topology": d.get("topology"),
        "back_annotation": fid.back_annotation,
        "verify_engine": fid.verify_engine,
        "use_kernel": fid.use_kernel,
        "co_design": scenario.co_design,
    }, sort_keys=True)


@dataclasses.dataclass
class ServeRequest:
    """One in-flight scenario request: spec + lifecycle stamps + outcome."""

    rid: Any
    scenario: Scenario
    key: str
    submit_time_s: float                     # perf_counter stamps
    admit_time_s: float = 0.0
    finish_time_s: float = 0.0
    cached: bool = False                     # answered from the report cache
    report: Optional[Dict[str, Any]] = None  # golden-format report dict
    error: Optional[str] = None
    machine: Optional[IncrementalDSE] = None
    problem: Any = None
    stage2_time_s: float = 0.0               # this request's share of chunks
    stage4_time_s: float = 0.0

    @property
    def done(self) -> bool:
        return self.report is not None or self.error is not None

    @property
    def wall_time_s(self) -> float:
        """Queue + compute: submission to completion."""
        return max(self.finish_time_s - self.submit_time_s, 0.0)

    def summary_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "rid": self.rid,
            "scenario": self.scenario.name,
            "cached": self.cached,
            "wall_time_s": self.wall_time_s,
        }
        if self.error is not None:
            out["error"] = self.error
        elif self.report is not None:
            out["best"] = self.report.get("best")
            out["n_verified"] = self.report.get("n_verified")
        return out


class DSEServeEngine:
    """Continuously-batched DSE service (in-process; the ``spac serve`` CLI
    and the test :class:`Client` both drive exactly this object).

    ``slots``: concurrent scenario requests multiplexed per tick.
    ``batch_width`` / ``verify_width``: the fixed stage-2 / stage-4 chunk
    shapes; partial chunks pad by repeating the last row (row-independent,
    and the kernel engines dedup identical rows, so pad rows are near-free).
    ``mesh``: optional ``MeshSpec``/device count sharding every chunk across
    a mesh of ``device``'s type — reports stay bit-identical to the serial
    path.  ``device``: where every chunk runs (default: the first CUDA
    device).
    """

    def __init__(self, *, slots: int = 4, batch_width: int = 64,
                 verify_width: int = 16, mesh=None, device=None):
        if batch_width < 1 or verify_width < 1:
            raise ValueError("batch_width/verify_width must be >= 1")
        self.batch_width = batch_width
        self.verify_width = verify_width
        mesh = MeshSpec.coerce(mesh) if mesh is not None else None
        self.mesh = None if mesh is None or mesh.is_single() else mesh
        self.device = resolve_device(device)
        if self.mesh is not None:
            self.mesh.build(self.device)    # more shards than devices: raise now
        self._slots: SlotArray[ServeRequest] = SlotArray(slots)
        self._traces: Dict[str, Tuple[Any, Any]] = {}
        self._problems: Dict[str, Any] = {}
        self._reports: Dict[str, Dict[str, Any]] = {}
        self._next_rid = 0
        self._ticks = 0
        self.stage2_time_s = 0.0
        self.stage4_time_s = 0.0
        self.counters: Dict[str, int] = {
            "report_hits": 0, "report_misses": 0,
            "trace_hits": 0, "trace_misses": 0,
            "problem_hits": 0, "problem_misses": 0,
            "stage2_rows": 0, "stage2_pad_rows": 0, "stage2_chunks": 0,
            "stage4_rows": 0, "stage4_pad_rows": 0, "stage4_chunks": 0,
            "requests": 0, "errors": 0,
        }

    # ------------------------------------------------------------- frontend
    def submit(self, scenario: Union[Scenario, str, Mapping[str, Any]], *,
               seed: Optional[int] = None, rid: Any = None) -> ServeRequest:
        """Queue one scenario request; returns the live :class:`ServeRequest`
        (its ``report`` fills in once served).  ``seed`` overrides the trace
        generator seed, so ``(scenario, seed)`` is the request identity."""
        if isinstance(scenario, str):
            scenario = registry[scenario]
        elif isinstance(scenario, Mapping):
            scenario = Scenario.from_dict(scenario)
        if seed is not None:
            scenario = scenario.override(trace_params={"seed": int(seed)})
        if rid is None:
            rid = f"r{self._next_rid}"
        self._next_rid += 1
        req = ServeRequest(rid=rid, scenario=scenario,
                           key=request_key(scenario),
                           submit_time_s=time.perf_counter())
        self._slots.submit(rid, req)
        self.counters["requests"] += 1
        return req

    @property
    def drained(self) -> bool:
        return self._slots.drained

    # -------------------------------------------------------------- plumbing
    def _trace_and_features(self, scenario: Scenario):
        key = scenario.trace.key()
        hit = self._traces.get(key)
        if hit is not None:
            self.counters["trace_hits"] += 1
            return hit
        self.counters["trace_misses"] += 1
        from repro_torch.core.features import analyze
        tr = scenario.trace.build()
        entry = (tr, analyze(tr))
        self._traces[key] = entry
        _evict(self._traces, _MAX_TRACES)
        return entry

    def _problem(self, scenario: Scenario):
        """(problem, sla, budget) with the problem shared across requests —
        its ``layout_key``-memoized bind cache and its back-annotation warm
        up once and serve every later request."""
        key = _problem_key(scenario)
        hit = self._problems.get(key)
        if hit is not None:
            self.counters["problem_hits"] += 1
            return hit, scenario.sla, self._budget(scenario)
        self.counters["problem_misses"] += 1
        if scenario.domain == "switch":
            tr, feats = self._trace_and_features(scenario)
            problem, _, budget = build_problem(scenario, trace=tr,
                                               features=feats, mesh=self.mesh,
                                               device=self.device)
        else:
            problem, _, budget = build_problem(scenario, mesh=self.mesh,
                                               device=self.device)
        self._problems[key] = problem
        _evict(self._problems, _MAX_PROBLEMS)
        return problem, scenario.sla, budget

    def _budget(self, scenario: Scenario):
        from .runner import _default_budget
        return scenario.budget or _default_budget(scenario)

    def _start(self, req: ServeRequest) -> None:
        from .runner import _search_checkpoint_dir
        fid = req.scenario.fidelity
        problem, sla, budget = self._problem(req.scenario)
        req.problem = problem
        req.machine = IncrementalDSE(
            problem, sla, budget, delta=fid.delta, top_k=fid.top_k,
            search=req.scenario.search,
            checkpoint_dir=_search_checkpoint_dir(req.scenario))

    # ------------------------------------------------------------------ tick
    def step(self) -> int:
        """One service tick: admit, answer cache hits, fan one fixed-width
        chunk per (problem, fidelity) group, retire finished requests.
        Returns the number of occupied slots after the tick."""
        self._ticks += 1
        # keys some active request is already computing: a twin admitted
        # while its key is in flight waits in its slot (machine None) and is
        # served from the report cache when the original finishes, so
        # identical concurrent requests cost one computation
        inflight = {r.key for _, _, r in self._slots.active_slots()
                    if r.machine is not None}
        for slot, _, req in self._slots.admit():
            req.admit_time_s = time.perf_counter()
            if self._try_cached(slot, req):
                continue
            if req.key in inflight:
                continue                       # wait on the in-flight twin
            self.counters["report_misses"] += 1
            if self._try_start(slot, req):
                inflight.add(req.key)

        # ---- group the active slots' pending rows by (problem, fidelity)
        groups: Dict[Tuple[int, str], List[ServeRequest]] = {}
        order: List[Tuple[int, str]] = []
        for _, _, req in self._slots.active_slots():
            m = req.machine
            if m is None or m.done or not m.pending:
                continue
            gkey = (id(req.problem), m.kind)
            if gkey not in groups:
                groups[gkey] = []
                order.append(gkey)
            groups[gkey].append(req)

        for gkey in order:
            self._run_chunk(gkey[1], groups[gkey])

        # ---- retire finished machines
        for slot, _, req in list(self._slots.active_slots()):
            if req.machine is not None and req.machine.done:
                self._finalize(slot, req)

        # ---- resolve waiting twins: their original just finished (serve
        # from cache) or errored/got evicted (start them for real)
        still = {r.key for _, _, r in self._slots.active_slots()
                 if r.machine is not None}
        for slot, _, req in list(self._slots.active_slots()):
            if req.machine is not None or req.done:
                continue
            if self._try_cached(slot, req):
                continue
            if req.key not in still and self._try_start(slot, req):
                self.counters["report_misses"] += 1
                still.add(req.key)
        return len(self._slots)

    def _try_cached(self, slot: int, req: ServeRequest) -> bool:
        hit = self._reports.get(req.key)
        if hit is None:
            return False
        self.counters["report_hits"] += 1
        req.report = json.loads(json.dumps(hit))
        req.cached = True
        req.finish_time_s = time.perf_counter()
        self._slots.finish(slot)
        return True

    def _try_start(self, slot: int, req: ServeRequest) -> bool:
        try:
            self._start(req)
            return True
        except _DEVICE_FAULTS:
            raise                # a kernel fault is not the request's
        except Exception as e:  # noqa: BLE001 — a bad spec must not kill the service
            req.error = f"{type(e).__name__}: {e}"
            req.finish_time_s = time.perf_counter()
            self.counters["errors"] += 1
            self._slots.finish(slot)
            return False

    def _run_chunk(self, kind: str, members: List[ServeRequest]) -> None:
        """One fixed-width batched call for one (problem, kind) group: take a
        fair share of each member's pending rows, pad to the fixed width by
        repeating the last row, evaluate, slice each member's results back."""
        width = self.batch_width if kind == "surrogate" else self.verify_width
        problem = members[0].problem
        pendings = [m.machine.pending for m in members]
        shares = _fair_shares([len(p) for p in pendings], width)
        take: List[Any] = []
        for pending, n in zip(pendings, shares):
            take.extend(pending[:n])
        if not take:
            return
        pad = width - len(take)
        chunk = take + [take[-1]] * pad
        t0 = time.perf_counter()
        if kind == "surrogate":
            results = problem.surrogate_batch(chunk)
        else:
            results = problem.verify_batch(chunk)
        elapsed = time.perf_counter() - t0
        results = list(results)[:len(take)]
        off = 0
        for req, n in zip(members, shares):
            if n:
                req.machine.feed(results[off:off + n])
                off += n
            share_s = elapsed * n / max(len(take), 1)
            if kind == "surrogate":
                req.stage2_time_s += share_s
            else:
                req.stage4_time_s += share_s
        if kind == "surrogate":
            self.stage2_time_s += elapsed
            self.counters["stage2_rows"] += len(take)
            self.counters["stage2_pad_rows"] += pad
            self.counters["stage2_chunks"] += 1
        else:
            self.stage4_time_s += elapsed
            self.counters["stage4_rows"] += len(take)
            self.counters["stage4_pad_rows"] += pad
            self.counters["stage4_chunks"] += 1

    def _finalize(self, slot: int, req: ServeRequest) -> None:
        m = req.machine
        report = ScenarioReport(
            scenario=req.scenario, result=m.result, problem=req.problem,
            wall_time_s=time.perf_counter() - req.admit_time_s,
            stage2_candidates=m.stage2_candidates,
            stage2_time_s=req.stage2_time_s,
            stage4_candidates=m.stage4_candidates,
            stage4_time_s=req.stage4_time_s)
        d = report.to_dict()
        self._reports[req.key] = d
        _evict(self._reports, _MAX_REPORTS)
        req.report = json.loads(json.dumps(d))
        req.finish_time_s = time.perf_counter()
        req.machine = None                     # free the stage state
        self._slots.finish(slot)

    # -------------------------------------------------------------- driving
    def run_until_drained(self, max_ticks: int = 100_000) -> List[ServeRequest]:
        """Tick until queue and slots are empty; returns every completed
        request exactly once, in completion order."""
        for _ in range(max_ticks):
            if self._slots.drained:
                break
            self.step()
        return self._slots.harvest()

    def stats(self) -> Dict[str, Any]:
        """Cache hit/miss counters, chunk/pad accounting, throughput."""
        from repro_torch.sim import timeline
        out: Dict[str, Any] = dict(self.counters)
        out["ticks"] = self._ticks
        out["slots"] = self._slots.slots
        out["batch_width"] = self.batch_width
        out["verify_width"] = self.verify_width
        out["stage2_time_s"] = self.stage2_time_s
        out["stage4_time_s"] = self.stage4_time_s
        out["stage2_cands_per_sec"] = (
            self.counters["stage2_rows"] / max(self.stage2_time_s, 1e-12))
        out["stage4_cands_per_sec"] = (
            self.counters["stage4_rows"] / max(self.stage4_time_s, 1e-12))
        out["report_entries"] = len(self._reports)
        out["trace_entries"] = len(self._traces)
        out["problem_entries"] = len(self._problems)
        out["timeline"] = timeline.counters()
        return out


def _fair_shares(pending: List[int], width: int) -> List[int]:
    """Split ``width`` rows across members: even shares first (slot order
    breaks remainders), then leftover capacity greedily — so one request
    with a huge queue cannot starve its group-mates."""
    n = len(pending)
    shares = [0] * n
    remaining = width
    base = max(1, width // max(n, 1))
    for i, p in enumerate(pending):
        shares[i] = min(p, base, remaining)
        remaining -= shares[i]
    for i, p in enumerate(pending):
        if remaining <= 0:
            break
        extra = min(p - shares[i], remaining)
        shares[i] += extra
        remaining -= extra
    return shares


class Client:
    """In-process client for tests and notebooks: submit scenarios, drive
    the engine, read golden-format reports."""

    def __init__(self, engine: Optional[DSEServeEngine] = None, **engine_kw):
        self.engine = engine if engine is not None else DSEServeEngine(**engine_kw)

    def submit(self, scenario, *, seed: Optional[int] = None) -> ServeRequest:
        return self.engine.submit(scenario, seed=seed)

    def result(self, req: ServeRequest, *, max_ticks: int = 100_000) -> Dict[str, Any]:
        """Drive the engine until ``req`` completes; returns its report dict
        (raises on a request that errored)."""
        for _ in range(max_ticks):
            if req.done:
                break
            self.engine.step()
        if req.error is not None:
            raise RuntimeError(f"request {req.rid}: {req.error}")
        if req.report is None:
            raise TimeoutError(f"request {req.rid} still pending after "
                               f"{max_ticks} ticks")
        return req.report

    def drain(self) -> List[ServeRequest]:
        return self.engine.run_until_drained()
