"""Multi-hop fabric layer of the port: so far only ``topology``, the
serializable leaf/spine, fat-tree and ring topologies with deterministic
flow-hash ECMP routing (a copy of the JAX package's ``fabric/topology.py``;
``Scenario.topology`` and the registry's ``fattree_dc`` entry carry one).
Evaluating a fabric (``fabric/evaluate.py``, ``fabric/problem.py``) is not
ported yet: running a scenario with a topology raises
``NotImplementedError`` (ROADMAP queue 1, item 7).
"""

from .topology import (TOPOLOGY_KINDS, FatTree, Hop, LeafSpine, Ring, Tier,
                       Topology, TopologySpec, build_topology, flow_hash)

__all__ = [
    "FatTree",
    "Hop",
    "LeafSpine",
    "Ring",
    "TOPOLOGY_KINDS",
    "Tier",
    "Topology",
    "TopologySpec",
    "build_topology",
    "flow_hash",
]
