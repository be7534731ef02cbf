"""Declarative Scenario/Campaign API of the port — its front door.

One serializable ``Scenario`` spec carries an experiment from protocol
definition to verified Pareto front; ``registry`` holds the paper's workload
scenarios; ``run_scenario``/``run_campaign`` execute one or many on a CUDA
device (``device="cpu"`` for the kernels' plain versions);
``repro_torch.api.cli`` is the ``python -m repro_torch`` entry point.  The
port of the JAX package's ``api`` without its serving engine
(``service.py``, ROADMAP queue 1, item 2).
"""

from .registry import ScenarioRegistry, registry
from .runner import (CampaignReport, ScenarioReport, build_bound,
                     build_problem, run_campaign, run_scenario)
from .scenario import (CommModelSpec, Fidelity, FieldSpec, MeshSpec,
                       PROTOCOL_BUILDERS, ProtocolSpec, Scenario, SearchSpec,
                       TopologySpec, TraceSpec)

__all__ = [
    "CampaignReport", "CommModelSpec", "Fidelity", "FieldSpec", "MeshSpec",
    "PROTOCOL_BUILDERS", "ProtocolSpec", "Scenario", "ScenarioRegistry",
    "ScenarioReport", "SearchSpec", "TopologySpec", "TraceSpec",
    "build_bound", "build_problem", "registry", "run_campaign",
    "run_scenario",
]
