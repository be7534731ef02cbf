"""Declarative Scenario/Campaign API of the port — its front door.

One serializable ``Scenario`` spec carries an experiment from protocol
definition to verified Pareto front; ``registry`` holds the paper's workload
scenarios; ``run_scenario``/``run_campaign`` execute one or many on a CUDA
device (``device="cpu"`` for the kernels' plain versions);
``DSEServeEngine``/``Client`` serve a stream of scenario requests through
shared fixed-width batched calls with content-addressed caching;
``repro_torch.api.cli`` is the ``python -m repro_torch`` entry point.
"""

from .registry import ScenarioRegistry, registry
from .runner import (CampaignReport, ScenarioReport, build_bound,
                     build_problem, run_campaign, run_scenario)
from .scenario import (CommModelSpec, Fidelity, FieldSpec, MeshSpec,
                       PROTOCOL_BUILDERS, ProtocolSpec, Scenario, SearchSpec,
                       TopologySpec, TraceSpec)
from .service import Client, DSEServeEngine, ServeRequest, strip_times

__all__ = [
    "CampaignReport", "Client", "CommModelSpec", "DSEServeEngine",
    "Fidelity", "FieldSpec", "MeshSpec", "PROTOCOL_BUILDERS", "ProtocolSpec",
    "Scenario", "ScenarioRegistry", "ScenarioReport", "ServeRequest",
    "SearchSpec", "TopologySpec", "TraceSpec", "build_bound", "build_problem",
    "registry", "run_campaign", "run_scenario", "strip_times",
]
