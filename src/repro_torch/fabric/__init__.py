"""Multi-hop fabric layer: topologies of co-designed switches.

``topology`` — serializable leaf/spine, fat-tree and ring topologies with
deterministic flow-hash ECMP routing; ``evaluate`` — the hop-by-hop
composition of the batched stage-2/stage-4 engines; ``problem`` — the joint
per-tier ``FabricDSEProblem`` the search engine optimises end-to-end.
(The port's copy of the JAX package's ``fabric`` package; the engines run
on ``device``, the first CUDA device unless told otherwise.)
"""

from .evaluate import (FabricRoutes, evaluate_fabric_batched, fabric_routes,
                       flatten_tier_arch, surrogate_fabric_batched)
from .problem import FabricCandidate, FabricDSEProblem, TIER_DIM_PREFIX
from .topology import (TOPOLOGY_KINDS, FatTree, Hop, LeafSpine, Ring, Tier,
                       Topology, TopologySpec, build_topology, flow_hash)

__all__ = [
    "FabricCandidate",
    "FabricDSEProblem",
    "FabricRoutes",
    "FatTree",
    "Hop",
    "LeafSpine",
    "Ring",
    "TIER_DIM_PREFIX",
    "TOPOLOGY_KINDS",
    "Tier",
    "Topology",
    "TopologySpec",
    "build_topology",
    "evaluate_fabric_batched",
    "fabric_routes",
    "flatten_tier_arch",
    "flow_hash",
    "surrogate_fabric_batched",
]
