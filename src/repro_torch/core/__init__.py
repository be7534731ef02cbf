"""SPAC core: protocol DSL, semantic binding, architecture space, DSE engine.

This package is the paper's primary contribution (SS III-A, SS IV-B) and is
shared by both halves of the repo: the faithful FPGA-switch reproduction
(``repro.switch`` / ``repro.sim``) and the TPU training-framework adaptation
(``repro.comm`` / ``repro.launch``).
"""

from .archspec import (
    AUTO,
    ArchRequest,
    BUS_WIDTHS,
    CustomKernelSpec,
    ForwardTableKind,
    SchedulerKind,
    SwitchArch,
    VOQKind,
    enumerate_candidates,
)
from .binding import BoundProtocol, SemanticBinding, bind
from .dse import (
    DSEProblem,
    DSEResult,
    ResourceBudget,
    SLA,
    StageLog,
    SurrogateResult,
    VerifyResult,
    depth_for_drop_rate,
    finalize_result,
    run_dse,
    stage1_static,
    stage2_screen,
    stage3_size,
    stage3_verify,
    stage4_verify,
)
from .dsl import (
    ETHERNET_HEADER_BYTES,
    Field,
    FieldSpec,
    ParserPlan,
    Protocol,
    ProtocolSpace,
    compressed_protocol,
    compressed_protocol_space,
    ethernet_ipv4_udp,
    layout_key,
)
from .features import TraceFeatures, analyze
from .pareto import hypervolume_2d, is_dominated, pareto_front
from .search import (
    DesignSpace,
    Dim,
    NSGA2Search,
    SearchDriver,
    SearchOutcome,
    SearchSpec,
    evaluate_space,
    run_search,
)

__all__ = [
    "AUTO", "ArchRequest", "BUS_WIDTHS", "BoundProtocol", "CustomKernelSpec",
    "DSEProblem", "DSEResult", "DesignSpace", "Dim", "ETHERNET_HEADER_BYTES",
    "Field", "FieldSpec", "ForwardTableKind", "NSGA2Search", "ParserPlan",
    "Protocol", "ProtocolSpace", "ResourceBudget", "SLA", "SchedulerKind",
    "SearchDriver", "SearchOutcome", "SearchSpec", "SemanticBinding",
    "StageLog", "SurrogateResult", "SwitchArch", "TraceFeatures", "VOQKind",
    "VerifyResult", "analyze", "bind", "compressed_protocol",
    "compressed_protocol_space", "depth_for_drop_rate", "enumerate_candidates",
    "ethernet_ipv4_udp", "evaluate_space", "finalize_result", "hypervolume_2d",
    "is_dominated", "layout_key", "pareto_front", "run_dse", "run_search",
    "stage1_static", "stage2_screen", "stage3_size", "stage3_verify",
    "stage4_verify",
]
