"""Declarative, serializable experiment specs: one ``Scenario`` from protocol
to Pareto front.  (The port's copy of the JAX package's ``api/scenario.py``;
a scenario dict from either package loads in the other.)

The paper's pitch (§III) is a *unified workflow*: one spec drives the parser
generator, the simulator stack, and the trace-aware DSE.  A ``Scenario``
bundles everything one experiment needs —

  * the protocol (a stock constructor by name + params, or an inline
    field-by-field layout), the flit width and semantic-binding overrides,
  * the traffic trace (a ``repro_torch.traces`` generator by name + params, or a
    ``Trace.save``d ``.npz`` by path),
  * the architecture request (``ArchRequest`` with ``AUTO`` policies) for the
    switch domain, or a ``CommModelSpec`` for the TPU comm domain,
  * the ``SLA``, the ``ResourceBudget``, and the fidelity knobs,

— and round-trips through ``to_dict()/from_dict()`` + JSON, so every
experiment is a reproducible config file (``spac run``/``spac sweep`` consume
exactly these).  All spec classes are frozen dataclasses; equality is
structural and survives the JSON round-trip bit-for-bit.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import math
from typing import Any, Dict, Mapping, Optional, Tuple, Union

from repro_torch.core.archspec import (AUTO, ArchRequest, CustomKernelSpec,
                                       ForwardTableKind, SchedulerKind, VOQKind)
from repro_torch.core.binding import KNOWN_SEMANTICS, SemanticBinding
from repro_torch.core.dse import ResourceBudget, SLA, USE_KERNEL_MODES, VERIFY_ENGINES
from repro_torch.core.dsl import (CODESIGN_ADDR_CHOICES, CODESIGN_LENGTH_CHOICES,
                                  CODESIGN_QOS_CHOICES, CODESIGN_SEQ_CHOICES, Field,
                                  FieldSpec, Protocol, ProtocolSpace,
                                  compressed_protocol, compressed_protocol_space,
                                  ethernet_ipv4_udp)
from repro_torch.core.search import SearchSpec
from repro_torch.fabric.topology import TopologySpec
from repro_torch.launch.mesh import MeshSpec

__all__ = [
    "ProtocolSpec",
    "TraceSpec",
    "CommModelSpec",
    "Fidelity",
    "FieldSpec",
    "MeshSpec",
    "Scenario",
    "SearchSpec",
    "TopologySpec",
    "PROTOCOL_BUILDERS",
]

#: stock protocol constructors a ``ProtocolSpec`` may reference by name
PROTOCOL_BUILDERS = {
    "compressed_protocol": compressed_protocol,
    "ethernet_ipv4_udp": ethernet_ipv4_udp,
}


# --------------------------------------------------------------------------
# serialization helpers
# --------------------------------------------------------------------------

def _num_to_json(x: float):
    """Floats must survive json.dumps with standard-compliant output."""
    if isinstance(x, float) and math.isinf(x):
        return "inf" if x > 0 else "-inf"
    return x


def _num_from_json(x):
    if x == "inf":
        return math.inf
    if x == "-inf":
        return -math.inf
    return x


_ENUMS = {"fwd": ForwardTableKind, "voq": VOQKind, "sched": SchedulerKind}


def _policy_to_json(v):
    if v is AUTO:
        return "auto"
    if isinstance(v, (ForwardTableKind, VOQKind, SchedulerKind)):
        return v.value
    return v


def _policy_from_json(key: str, v):
    if v == "auto":
        return AUTO
    if key in _ENUMS and isinstance(v, str):
        return _ENUMS[key](v)
    return v


def arch_to_dict(req: ArchRequest) -> Dict[str, Any]:
    d = {
        "n_ports": req.n_ports,
        "addr_bits": req.addr_bits,
        "bus_bits": _policy_to_json(req.bus_bits),
        "fwd": _policy_to_json(req.fwd),
        "voq": _policy_to_json(req.voq),
        "sched": _policy_to_json(req.sched),
        "voq_depth": _policy_to_json(req.voq_depth),
    }
    if req.custom_kernels:
        # the *performance interface* is declarative and serializes; the
        # functional model (fn) is code and cannot — reattach it in code
        d["custom_kernels"] = [
            {"name": k.name, "ii": k.ii, "latency_cycles": k.latency_cycles,
             "luts": k.luts, "ffs": k.ffs, "brams": k.brams}
            for k in req.custom_kernels
        ]
    return d


def arch_from_dict(d: Mapping[str, Any]) -> ArchRequest:
    kernels = tuple(CustomKernelSpec(**k) for k in d.get("custom_kernels", ()))
    return ArchRequest(
        n_ports=int(d["n_ports"]),
        addr_bits=int(d["addr_bits"]),
        bus_bits=_policy_from_json("bus_bits", d.get("bus_bits", "auto")),
        fwd=_policy_from_json("fwd", d.get("fwd", "auto")),
        voq=_policy_from_json("voq", d.get("voq", "auto")),
        sched=_policy_from_json("sched", d.get("sched", "auto")),
        voq_depth=_policy_from_json("voq_depth", d.get("voq_depth", "auto")),
        custom_kernels=kernels,
    )


def sla_to_dict(sla: SLA) -> Dict[str, Any]:
    return {
        "p99_latency_ns": _num_to_json(sla.p99_latency_ns),
        "drop_rate": sla.drop_rate,
        "min_throughput_gbps": sla.min_throughput_gbps,
    }


def sla_from_dict(d: Mapping[str, Any]) -> SLA:
    return SLA(
        p99_latency_ns=float(_num_from_json(d.get("p99_latency_ns", "inf"))),
        drop_rate=float(d.get("drop_rate", 1e-3)),
        min_throughput_gbps=float(d.get("min_throughput_gbps", 0.0)),
    )


# --------------------------------------------------------------------------
# component specs
# --------------------------------------------------------------------------

#: default co-design width menus per ``compressed_protocol`` parameter —
#: what ``ProtocolSpec.widen()`` (and ``spac run --co-design``) opens up
_WIDEN_CHOICES = {
    "addr_bits": CODESIGN_ADDR_CHOICES,
    "qos_bits": CODESIGN_QOS_CHOICES,
    "length_bits": CODESIGN_LENGTH_CHOICES,
    "seq_bits": CODESIGN_SEQ_CHOICES,
}
#: the builder's own defaults, read off its signature so they cannot drift
_COMPRESSED_DEFAULTS = {
    k: p.default
    for k, p in inspect.signature(compressed_protocol).parameters.items()
    if k in ("addr_bits", "qos_bits", "length_bits", "seq_bits")
}


def _as_choices(v):
    """Width choice lists -> canonical int tuples; everything else verbatim."""
    if isinstance(v, (list, tuple)) and v \
            and all(isinstance(x, (int, float)) and not isinstance(x, bool) for x in v):
        return tuple(int(x) for x in v)
    return v


def _is_choices(v) -> bool:
    return isinstance(v, tuple) and bool(v) and all(isinstance(x, int) for x in v)


@dataclasses.dataclass(frozen=True)
class ProtocolSpec:
    """Protocol by stock constructor name + params, or inline field layout.

    Any width parameter (and any inline field's ``bits``) may be a *list* of
    choices instead of a point — the spec then describes a ``ProtocolSpace``
    (``space()``) the co-design DSE searches jointly with the architecture.
    Ranged specs serialize exactly like point specs (choices are JSON
    arrays) and round-trip bit-for-bit."""

    builder: str = "compressed_protocol"    # a PROTOCOL_BUILDERS key | "inline"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    name: Optional[str] = None              # protocol name for inline layouts
    fields: Optional[Tuple[Union[Field, FieldSpec], ...]] = None

    def __post_init__(self):
        if self.builder == "inline":
            if not self.fields:
                raise ValueError("inline ProtocolSpec needs a non-empty fields tuple")
        elif self.builder not in PROTOCOL_BUILDERS:
            raise ValueError(
                f"unknown protocol builder {self.builder!r}; "
                f"known: {sorted(PROTOCOL_BUILDERS)} or 'inline'")
        # canonical form: ranged width params are int tuples (lists arrive
        # from JSON); non-numeric sequences (extra_fields) pass through
        params = {k: _as_choices(v) for k, v in self.params.items()}
        object.__setattr__(self, "params", params)

    @staticmethod
    def inline(protocol: Protocol) -> "ProtocolSpec":
        """Capture an existing ``Protocol`` field-by-field."""
        return ProtocolSpec(builder="inline", name=protocol.name,
                            fields=tuple(protocol.fields))

    # ----------------------------------------------------------- point vs space
    @property
    def is_space(self) -> bool:
        """True iff any parameter/field carries more than a point value."""
        if any(_is_choices(v) for v in self.params.values()):
            return True
        return any(isinstance(f, FieldSpec) for f in (self.fields or ()))

    def build(self) -> Protocol:
        if self.is_space:
            raise ValueError(
                "ranged ProtocolSpec describes a protocol *space*, not one "
                "protocol; run the scenario with co_design=True (spac run "
                "--co-design) or pin every width to a single value")
        if self.builder == "inline":
            return Protocol(self.name or "inline", self.fields)
        return PROTOCOL_BUILDERS[self.builder](**dict(self.params))

    def space(self) -> ProtocolSpace:
        """The spec as a ``ProtocolSpace`` (point params become single-choice
        dimensions)."""
        if self.builder == "inline":
            specs = tuple(f if isinstance(f, FieldSpec) else FieldSpec.fixed(f)
                          for f in self.fields)
            return ProtocolSpace(self.name or "inline", specs)
        if self.builder == "compressed_protocol":
            p = dict(self.params)
            name = p.pop("name", "spac_compressed")
            extra = tuple(p.pop("extra_fields", ()))
            kw = {k: p.pop(k, _COMPRESSED_DEFAULTS[k])
                  for k in _COMPRESSED_DEFAULTS}
            if p:
                raise ValueError(f"unknown compressed_protocol params {sorted(p)}")
            return compressed_protocol_space(name=name, extra_fields=extra, **kw)
        raise ValueError(
            f"protocol builder {self.builder!r} has a fixed layout and no "
            "searchable space; use the compressed_protocol builder or inline "
            "FieldSpec fields for co-design")

    def widen(self) -> "ProtocolSpec":
        """Open the default co-design width menus around a point spec (the
        ``--co-design`` CLI toggle): each ``compressed_protocol`` width
        parameter becomes its default choice set, always including the
        pinned value so the original layout stays reachable."""
        if self.is_space:
            return self
        if self.builder != "compressed_protocol":
            raise ValueError(
                f"cannot widen builder {self.builder!r}; co-design default "
                "ranges exist for compressed_protocol only — give explicit "
                "ranged params or inline FieldSpec fields")
        params = dict(self.params)
        for k, menu in _WIDEN_CHOICES.items():
            pinned = int(params.get(k, _COMPRESSED_DEFAULTS[k]))
            params[k] = tuple(sorted(set(menu) | {pinned}))
        return dataclasses.replace(self, params=params)

    # -------------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"builder": self.builder}
        if self.params:
            d["params"] = {k: list(v) if isinstance(v, tuple) else v
                           for k, v in self.params.items()}
        if self.name is not None:
            d["name"] = self.name
        if self.fields is not None:
            d["fields"] = [
                {"name": f.name,
                 "bits": list(f.bits) if isinstance(f, FieldSpec) else f.bits,
                 "semantic": f.semantic, "default": f.default}
                for f in self.fields
            ]
        return d

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "ProtocolSpec":
        fields = d.get("fields")
        if fields is not None:
            fields = tuple(
                FieldSpec(f["name"], tuple(f["bits"]), f.get("semantic"),
                          f.get("default", 0))
                if isinstance(f["bits"], (list, tuple)) else Field(**f)
                for f in fields)
        return ProtocolSpec(
            builder=d.get("builder", "compressed_protocol"),
            params=dict(d.get("params", {})),
            name=d.get("name"),
            fields=fields,
        )


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Traffic by generator name (``repro_torch.traces.WORKLOADS``) or saved file."""

    generator: Optional[str] = None         # a WORKLOADS key
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    path: Optional[str] = None              # Trace.save()d .npz

    def __post_init__(self):
        if (self.generator is None) == (self.path is None):
            raise ValueError("TraceSpec needs exactly one of generator / path")

    def build(self):
        from repro_torch.traces import Trace
        from repro_torch.traces.workloads import WORKLOADS
        if self.path is not None:
            return Trace.load(self.path)
        if self.generator not in WORKLOADS:
            raise ValueError(f"unknown trace generator {self.generator!r}; "
                             f"known: {sorted(WORKLOADS)}")
        return WORKLOADS[self.generator](**dict(self.params))

    def key(self) -> str:
        """Canonical identity — campaigns share one built trace per key."""
        return json.dumps(self.to_dict(), sort_keys=True)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.generator is not None:
            d["generator"] = self.generator
        if self.params:
            d["params"] = dict(self.params)
        if self.path is not None:
            d["path"] = self.path
        return d

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "TraceSpec":
        return TraceSpec(generator=d.get("generator"),
                         params=dict(d.get("params", {})),
                         path=d.get("path"))


@dataclasses.dataclass(frozen=True)
class CommModelSpec:
    """The comm-domain analogue of ``ArchRequest``: the MoE/gradient-bucket
    model whose routing trace drives ``CommDSEProblem``."""

    d_model: int = 512
    d_ff: int = 1024
    n_heads: int = 8
    n_kv_heads: int = 4
    vocab: int = 1000
    moe_experts: int = 32
    moe_topk: int = 4
    batch: int = 8
    seq: int = 256
    seed: int = 0
    model_tp: int = 16          # tensor extent for the analytic fabric model
    router: str = "learned_topk"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "CommModelSpec":
        return CommModelSpec(**dict(d))


@dataclasses.dataclass(frozen=True)
class Fidelity:
    """Knobs trading DSE speed for accuracy (stage granularity unchanged)."""

    back_annotation: bool = True   # η from the cycle sim vs the analytic fits
    delta: float = 0.2             # stage-1 timing slack
    top_k: int = 8                 # stage-3 exploration width
    #: stage-4 rung on the fidelity ladder: "netsim" verifies every sized
    #: survivor with the batched finite-buffer event sim; "cycle" runs the
    #: cycle-accurate datapath for every survivor (slow); "auto" verifies the
    #: front with batched netsim and escalates only the champion to cycle-sim
    verify_engine: str = "netsim"
    #: segmented netsim-kernel knob for the batched stage-2/4 engines:
    #: "auto" (kernel when available, oracle fallback), "on", "off".
    #: Bools normalise to "on"/"off" so JSON round-trips stay canonical.
    use_kernel: str = "auto"

    def __post_init__(self):
        if self.verify_engine not in VERIFY_ENGINES:
            raise ValueError(f"unknown verify_engine {self.verify_engine!r}; "
                             f"known: {VERIFY_ENGINES}")
        if isinstance(self.use_kernel, bool):
            object.__setattr__(self, "use_kernel",
                               "on" if self.use_kernel else "off")
        if self.use_kernel not in USE_KERNEL_MODES:
            raise ValueError(f"unknown use_kernel {self.use_kernel!r}; "
                             f"known: {USE_KERNEL_MODES} or a bool")

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        # "auto" is the default and resolves per-environment; omitting it
        # keeps serialised scenarios (and their goldens) stable across
        # versions that predate the knob
        if d["use_kernel"] == "auto":
            del d["use_kernel"]
        return d

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "Fidelity":
        return Fidelity(**dict(d))


# --------------------------------------------------------------------------
# the Scenario
# --------------------------------------------------------------------------

#: override() sentinel — None is a meaningful value for ``search``
_KEEP = object()


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One experiment, declaratively: protocol → binding → trace → DSE → SLA.

    ``domain`` selects the problem family: ``"switch"`` (the paper's FPGA
    switch, needs ``arch``) or ``"comm"`` (the TPU dispatch fabric, needs
    ``comm``).  ``budget=None`` means the domain default (Alveo U45N for
    switch, 4 GB dispatch-buffer HBM for comm).
    """

    name: str
    domain: str = "switch"
    protocol: ProtocolSpec = ProtocolSpec()
    flit_bits: int = 256
    binding: Dict[str, str] = dataclasses.field(default_factory=dict)
    trace: TraceSpec = TraceSpec(generator="uniform")
    arch: Optional[ArchRequest] = None
    comm: Optional[CommModelSpec] = None
    sla: SLA = SLA()
    budget: Optional[ResourceBudget] = None
    fidelity: Fidelity = Fidelity()
    #: None -> exhaustive enumeration (stages 1-2); a SearchSpec -> the
    #: seeded generational NSGA-II engine over the problem's space()
    search: Optional[SearchSpec] = None
    #: protocol/architecture co-design: the protocol spec's width ranges
    #: become genes next to the architecture genes (switch domain + search
    #: only; ``override(co_design=True)`` widens a point spec automatically)
    co_design: bool = False
    #: optional MeshSpec sharding the batched DSE stages across devices;
    #: None (the default, and what every golden snapshot records) is the
    #: serial path; results are bit-identical either way
    mesh: Optional[MeshSpec] = None
    #: optional multi-hop fabric: the scenario evaluates a *network* of
    #: switches (``repro_torch.fabric``) — each topology tier is its own design
    #: point, the trace routes hop-by-hop, and objectives are end-to-end
    #: (switch domain only; None keeps the single-switch path)
    topology: Optional[TopologySpec] = None
    notes: str = ""

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, MeshSpec):
            object.__setattr__(self, "mesh", MeshSpec.coerce(self.mesh))
        if self.domain not in ("switch", "comm"):
            raise ValueError(f"unknown domain {self.domain!r}")
        if self.topology is not None and self.domain != "switch":
            raise ValueError(f"scenario {self.name!r}: topology applies to "
                             "the switch domain only")
        if self.domain == "switch" and self.arch is None:
            raise ValueError(f"scenario {self.name!r}: switch domain needs arch")
        if self.domain == "comm" and self.comm is None:
            raise ValueError(f"scenario {self.name!r}: comm domain needs comm")
        unknown = set(self.binding) - set(KNOWN_SEMANTICS)
        if unknown:
            raise ValueError(f"scenario {self.name!r}: unknown binding "
                             f"semantics {sorted(unknown)}")
        if self.co_design:
            if self.domain != "switch":
                raise ValueError(f"scenario {self.name!r}: co_design applies "
                                 "to the switch domain only")
            if not self.protocol.is_space:
                raise ValueError(
                    f"scenario {self.name!r}: co_design=True needs ranged "
                    "protocol params (list-valued widths) — "
                    "override(co_design=True) widens the defaults")

    # ------------------------------------------------------------- building
    def semantic_binding(self) -> SemanticBinding:
        return SemanticBinding(**self.binding)

    # -------------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "domain": self.domain,
            "protocol": self.protocol.to_dict(),
            "flit_bits": self.flit_bits,
            "trace": self.trace.to_dict(),
            "sla": sla_to_dict(self.sla),
            "fidelity": self.fidelity.to_dict(),
        }
        if self.binding:
            d["binding"] = dict(self.binding)
        if self.arch is not None:
            d["arch"] = arch_to_dict(self.arch)
        if self.comm is not None:
            d["comm"] = self.comm.to_dict()
        if self.budget is not None:
            d["budget"] = {"limits": {k: _num_to_json(v)
                                      for k, v in self.budget.limits.items()}}
        if self.search is not None:
            d["search"] = self.search.to_dict()
        if self.co_design:
            d["co_design"] = True
        if self.mesh is not None:
            d["mesh"] = self.mesh.to_dict()
        if self.topology is not None:
            d["topology"] = self.topology.to_dict()
        if self.notes:
            d["notes"] = self.notes
        return d

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "Scenario":
        arch = d.get("arch")
        comm = d.get("comm")
        budget = d.get("budget")
        search = d.get("search")
        return Scenario(
            name=d["name"],
            domain=d.get("domain", "switch"),
            protocol=ProtocolSpec.from_dict(d.get("protocol", {})),
            flit_bits=int(d.get("flit_bits", 256)),
            binding=dict(d.get("binding", {})),
            trace=TraceSpec.from_dict(d.get("trace", {"generator": "uniform"})),
            arch=arch_from_dict(arch) if arch is not None else None,
            comm=CommModelSpec.from_dict(comm) if comm is not None else None,
            sla=sla_from_dict(d.get("sla", {})),
            budget=(ResourceBudget({k: float(_num_from_json(v))
                                    for k, v in budget["limits"].items()})
                    if budget is not None else None),
            fidelity=Fidelity.from_dict(d.get("fidelity", {})),
            search=SearchSpec.from_dict(search) if search is not None else None,
            co_design=bool(d.get("co_design", False)),
            mesh=(MeshSpec.from_dict(d["mesh"])
                  if d.get("mesh") is not None else None),
            topology=(TopologySpec.from_dict(d["topology"])
                      if d.get("topology") is not None else None),
            notes=d.get("notes", ""),
        )

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "Scenario":
        return Scenario.from_dict(json.loads(text))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @staticmethod
    def load(path) -> "Scenario":
        with open(path) as f:
            return Scenario.from_json(f.read())

    # ------------------------------------------------------------ overrides
    def override(
        self,
        *,
        search: Any = _KEEP,
        sla_p99_latency_ns: Optional[float] = None,
        sla_drop_rate: Optional[float] = None,
        sla_min_throughput_gbps: Optional[float] = None,
        trace_params: Optional[Mapping[str, Any]] = None,
        budget_limits: Optional[Mapping[str, float]] = None,
        back_annotation: Optional[bool] = None,
        delta: Optional[float] = None,
        top_k: Optional[int] = None,
        verify_engine: Optional[str] = None,
        use_kernel: Optional[str] = None,
        flit_bits: Optional[int] = None,
        co_design: Optional[bool] = None,
        devices: Optional[int] = None,
        scenario_devices: Optional[int] = None,
        name: Optional[str] = None,
    ) -> "Scenario":
        """Return a copy with the given knobs replaced (CLI flag surface).

        ``co_design=True`` on a point protocol spec widens it with the
        default co-design width menus (``ProtocolSpec.widen``), so
        ``registry["hft"].override(co_design=True, search=...)`` is the whole
        Table II header-adaptation experiment."""
        sla = SLA(
            p99_latency_ns=(self.sla.p99_latency_ns
                            if sla_p99_latency_ns is None else sla_p99_latency_ns),
            drop_rate=(self.sla.drop_rate
                       if sla_drop_rate is None else sla_drop_rate),
            min_throughput_gbps=(self.sla.min_throughput_gbps
                                 if sla_min_throughput_gbps is None
                                 else sla_min_throughput_gbps),
        )
        trace = self.trace
        if trace_params:
            if trace.generator is None:
                raise ValueError("trace params override needs a generator-"
                                 "sourced trace, not a file")
            trace = dataclasses.replace(
                trace, params={**trace.params, **dict(trace_params)})
        budget = self.budget
        if budget_limits:
            base = dict(budget.limits) if budget is not None else {}
            base.update(budget_limits)
            budget = ResourceBudget(base)
        fid = Fidelity(
            back_annotation=(self.fidelity.back_annotation
                             if back_annotation is None else back_annotation),
            delta=self.fidelity.delta if delta is None else delta,
            top_k=self.fidelity.top_k if top_k is None else top_k,
            verify_engine=(self.fidelity.verify_engine
                           if verify_engine is None else verify_engine),
            use_kernel=(self.fidelity.use_kernel
                        if use_kernel is None else use_kernel),
        )
        cd = self.co_design if co_design is None else co_design
        protocol = self.protocol
        if cd and not protocol.is_space:
            protocol = protocol.widen()
        elif co_design is False and protocol.is_space:
            # widening is lossy (the pinned point joins a menu), so there is
            # no way back — fail here with guidance instead of later with a
            # "turn co-design on" message that contradicts the user's ask
            raise ValueError(
                f"scenario {self.name!r}: cannot disable co-design on a "
                "ranged protocol spec (the original point widths are not "
                "recorded); pin each width to a single value or rebuild "
                "the scenario from the registry")
        mesh = self.mesh
        if devices is not None or scenario_devices is not None:
            base = mesh if mesh is not None else MeshSpec()
            mesh = MeshSpec(
                devices=base.devices if devices is None else devices,
                scenario_axis=(base.scenario_axis if scenario_devices is None
                               else scenario_devices))
            if mesh.is_single():
                mesh = None     # serial default serializes as no mesh at all
        return dataclasses.replace(
            self, sla=sla, trace=trace, budget=budget, fidelity=fid,
            search=self.search if search is _KEEP else search,
            flit_bits=self.flit_bits if flit_bits is None else flit_bits,
            co_design=cd, protocol=protocol, mesh=mesh,
            name=self.name if name is None else name,
        )
