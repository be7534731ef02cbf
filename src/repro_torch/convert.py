"""Carry the JAX package's state across to the port, without importing it.

``from_reference(obj)`` rebuilds a reference ``Trace``, ``SwitchArch``,
``ArchRequest``, ``BoundProtocol``, ``SLA`` or ``ResourceBudget`` (and the
pieces they hold: protocols, fields, parser plans, policies) as the port's
own type, from its fields and NumPy arrays.  It is duck-typed on the class
name, so it accepts the reference's objects while ``repro`` stays out of this
package's imports.  ``Trace.save``/``load`` keep the reference's ``.npz``
format, so a saved trace loads in either package.

``switch_problem_from_dict`` builds a ready-to-run ``SwitchDSEProblem`` from
the ``scenario`` entry of a reference ``ScenarioReport.to_dict()`` (the
golden reports under ``tests/golden/`` carry one): the single-switch subset
of the JAX package's ``api.runner.build_problem``.  ``report_dict`` turns a
``DSEResult`` back into the result entries of that same dict, so a port run
can be diffed against a golden report.  (The ``api`` layer itself is not
ported yet.)
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core import archspec, binding, dse, dsl, search
from repro_torch.sim.resources import ALVEO_U45N
from repro_torch.traces.base import Trace
from repro_torch.traces.workloads import WORKLOADS

__all__ = ["from_reference", "report_dict", "switch_problem_from_dict"]

_ENUMS = {cls.__name__: cls for cls in (archspec.ForwardTableKind,
                                         archspec.VOQKind,
                                         archspec.SchedulerKind)}
_DATACLASSES = {cls.__name__: cls for cls in (
    Trace, archspec.SwitchArch, archspec.ArchRequest, archspec.CustomKernelSpec,
    binding.BoundProtocol, binding.SemanticBinding, dsl.Field, dsl.FieldSpec,
    dsl.FieldSlice, dsl.ParserPlan, dse.SLA, dse.ResourceBudget,
    search.SearchSpec)}


def from_reference(obj: Any) -> Any:
    """The port's equivalent of a reference object (see the module note).

    Plain values, NumPy arrays and callables pass through; containers are
    converted element by element.  Raises ``TypeError`` for a type the
    port has no counterpart for."""
    if obj is None or isinstance(obj, (bool, int, float, str, np.ndarray,
                                       np.generic)):
        return obj
    name = type(obj).__name__
    if name == "_Auto":
        return archspec.AUTO
    if name in _ENUMS:
        return _ENUMS[name](obj.value)
    if isinstance(obj, (list, tuple)):
        return type(obj)(from_reference(x) for x in obj)
    if isinstance(obj, dict):
        return {k: from_reference(v) for k, v in obj.items()}
    if name == "Protocol":
        return dsl.Protocol(obj.name, [from_reference(f) for f in obj.fields])
    if name in _DATACLASSES and dataclasses.is_dataclass(obj):
        cls = _DATACLASSES[name]
        return cls(**{f.name: from_reference(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.init})
    if callable(obj):
        return obj
    raise TypeError(f"no repro_torch counterpart for {type(obj).__module__}."
                    f"{type(obj).__qualname__}")


# --------------------------------------------------------------------------
# scenario dicts (ScenarioReport.to_dict()["scenario"]) -> problems
# --------------------------------------------------------------------------

_PROTOCOL_BUILDERS = {"compressed_protocol": dsl.compressed_protocol,
                      "ethernet_ipv4_udp": dsl.ethernet_ipv4_udp}
#: the builder's own defaults, read off its signature so they cannot drift
_COMPRESSED_DEFAULTS = {
    k: p.default
    for k, p in inspect.signature(dsl.compressed_protocol).parameters.items()
    if k in ("addr_bits", "qos_bits", "length_bits", "seq_bits")
}
_POLICY_ENUMS = {"fwd": archspec.ForwardTableKind, "voq": archspec.VOQKind,
                 "sched": archspec.SchedulerKind}


def _policy(key: str, v):
    if v == "auto":
        return archspec.AUTO
    if key in _POLICY_ENUMS and isinstance(v, str):
        return _POLICY_ENUMS[key](v)
    return v


def _num(x):
    if x == "inf":
        return math.inf
    if x == "-inf":
        return -math.inf
    return x


def switch_problem_from_dict(
    d: Mapping[str, Any],
    *,
    device=None,
    trace_params: Optional[Mapping[str, Any]] = None,
) -> Tuple[Any, dse.SLA, dse.ResourceBudget, Dict[str, Any]]:
    """(problem, sla, budget, run_dse keyword arguments) for a serialized
    single-switch scenario.  ``trace_params`` overrides entries of the trace
    generator's parameters (a longer ``duration_s``, say).  Fabric and comm
    scenarios, saved-trace paths and inline protocols are not ported yet."""
    from repro_torch.sim.switch_problem import SwitchDSEProblem

    if d.get("domain", "switch") != "switch" or d.get("topology") is not None:
        raise NotImplementedError("only single-switch scenarios are ported")
    proto = d["protocol"]
    if proto.get("builder", "compressed_protocol") not in _PROTOCOL_BUILDERS:
        raise NotImplementedError(f"protocol builder {proto.get('builder')!r}")
    tspec = d["trace"]
    if "generator" not in tspec:
        raise NotImplementedError("saved-trace scenarios: build the trace with "
                                  "Trace.load and SwitchDSEProblem directly")
    a = d["arch"]
    if a.get("custom_kernels"):
        raise NotImplementedError("custom kernels carry code; build the "
                                  "ArchRequest in code")
    request = archspec.ArchRequest(
        n_ports=int(a["n_ports"]), addr_bits=int(a["addr_bits"]),
        **{k: _policy(k, a.get(k, "auto"))
           for k in ("bus_bits", "fwd", "voq", "sched", "voq_depth")})
    params = {**tspec.get("params", {}), **dict(trace_params or {})}
    trace = WORKLOADS[tspec["generator"]](**params)
    fid = d.get("fidelity", {})
    s = d.get("sla", {})
    sla = dse.SLA(p99_latency_ns=float(_num(s.get("p99_latency_ns", "inf"))),
                  drop_rate=float(s.get("drop_rate", 1e-3)),
                  min_throughput_gbps=float(s.get("min_throughput_gbps", 0.0)))
    limits = (d.get("budget") or {}).get("limits") or dict(ALVEO_U45N)
    budget = dse.ResourceBudget({k: float(_num(v)) for k, v in limits.items()})
    sem = binding.SemanticBinding(**d.get("binding", {}))
    flit_bits = int(d.get("flit_bits", 256))
    common = dict(back_annotation=bool(fid.get("back_annotation", True)),
                  verify_engine=fid.get("verify_engine", "netsim"),
                  use_kernel=fid.get("use_kernel", "auto"), device=device)
    pp = dict(proto.get("params", {}))
    if d.get("co_design"):
        name = pp.pop("name", "spac_compressed")
        extra = tuple(dsl.Field(**f) for f in pp.pop("extra_fields", ()))
        widths = {k: pp.pop(k, _COMPRESSED_DEFAULTS[k])
                  for k in _COMPRESSED_DEFAULTS}
        space = dsl.compressed_protocol_space(name=name, extra_fields=extra,
                                              **widths)
        problem = SwitchDSEProblem(request, None, trace, protocol_space=space,
                                   binding=sem, flit_bits=flit_bits, **common)
    else:
        protocol = _PROTOCOL_BUILDERS[proto.get("builder",
                                                "compressed_protocol")](**pp)
        bound = binding.bind(protocol, sem, flit_bits=flit_bits)
        problem = SwitchDSEProblem(request, bound, trace, **common)
    kwargs: Dict[str, Any] = {"delta": float(fid.get("delta", 0.2)),
                              "top_k": int(fid.get("top_k", 8))}
    if d.get("search") is not None:
        kwargs["search"] = search.SearchSpec(**d["search"])
    return problem, sla, budget, kwargs


def _verify_dict(v) -> Dict[str, float]:
    return {"p99_latency_ns": float(v.p99_latency_ns),
            "mean_latency_ns": float(v.mean_latency_ns),
            "drop_rate": float(v.drop_rate),
            "throughput_gbps": float(v.throughput_gbps)}


def report_dict(problem, result: dse.DSEResult) -> Dict[str, Any]:
    """The result entries of the reference's ``ScenarioReport.to_dict()``
    (``best``, ``best_verify``, ``best_protocol``, ``resources``,
    ``pareto``, ``stages``, ``n_verified``) for a single-switch run."""
    best = result.best
    bound = None
    if best is not None:
        bound = getattr(best, "bound", None) or getattr(problem, "bound", None)
    p = bound.protocol if bound is not None else None
    return {
        "best": best.short() if best is not None else None,
        "best_verify": (_verify_dict(result.best_verify)
                        if result.best_verify is not None else None),
        "best_protocol": None if p is None else {
            "name": p.name, "header_bits": int(p.header_bits),
            "header_bytes": int(p.header_bytes),
            "fields": [{"name": f.name, "bits": f.bits,
                        "semantic": f.semantic} for f in p.fields]},
        "resources": ({k: float(v) for k, v in problem.resources(best).items()}
                      if best is not None else {}),
        "pareto": [{"candidate": a.short(), **_verify_dict(v)}
                   for a, v in result.pareto],
        "stages": [{"stage": lg.stage, "considered": lg.considered,
                    "survived": lg.survived, "notes": list(lg.notes)}
                   for lg in result.logs],
        "n_verified": len(result.evaluated),
    }
