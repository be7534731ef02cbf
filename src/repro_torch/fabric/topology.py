"""Serializable fabric topologies — the network the switches compose into.

A :class:`Topology` arranges identical-per-tier switches (leaf/spine, k-ary
fat-tree, ring) around ``n_hosts`` end hosts.  Every switch in a tier is one
(arch, protocol) design point — the fabric DSE searches per-*tier* genes, not
per-node, which keeps the genome tractable (ROADMAP item 4).  The topology's
only runtime job is :meth:`Topology.route`: a deterministic hop list
``(tier, node, in_port, out_port)`` per (src, dst) pair, with equal-cost
multipath resolved by an explicit integer flow hash (no ``hash()``, no RNG —
routes are part of the golden-report contract).

Port numbering inside a node is local (``0..degree-1``); the multi-hop
evaluator flattens a whole tier into one super-switch by
``flat = node * degree + local`` (see ``repro_torch.fabric.evaluate``), so every
local port id must stay below the tier's degree.

:class:`TopologySpec` is the JSON-round-trippable half (``Scenario.topology``
carries one); ``spec.build()`` returns the live object.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Mapping, NamedTuple, Tuple

__all__ = ["Hop", "Tier", "Topology", "TopologySpec", "TOPOLOGY_KINDS",
           "build_topology", "flow_hash"]


class Hop(NamedTuple):
    """One switch traversal: which tier/node the packet enters, on which
    local ingress port, and which local egress port it leaves by."""

    tier: int
    node: int
    in_port: int
    out_port: int


class Tier(NamedTuple):
    """One homogeneous switch tier: ``n_nodes`` switches of ``degree`` ports
    each, all sharing a single (arch, protocol) design point."""

    name: str
    n_nodes: int
    degree: int


def flow_hash(src: int, dst: int) -> int:
    """Deterministic 32-bit flow mix for ECMP path selection.

    Knuth/Murmur-style odd-constant mixing over the (src, dst) pair —
    explicitly *not* Python's ``hash()``, which is salted per process and
    would make routes (and therefore goldens) irreproducible."""
    h = (src * 0x9E3779B1) & 0xFFFFFFFF
    h ^= (dst * 0x85EBCA6B + 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return (h * 0x27D4EB2F) & 0xFFFFFFFF


class Topology:
    """Base class: a tiered switch fabric around ``n_hosts`` end hosts.

    Subclasses fill ``tiers`` and implement :meth:`route`; everything else
    (node/link enumeration, validation, key) is shared."""

    kind: str = ""

    def __init__(self, params: Mapping[str, int]):
        self.params: Dict[str, int] = {k: int(v) for k, v in sorted(params.items())}
        self.n_hosts: int = 0
        self.tiers: Tuple[Tier, ...] = ()

    # ------------------------------------------------------------ structure
    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    @property
    def max_hops(self) -> int:
        raise NotImplementedError

    def nodes(self) -> List[Tuple[int, int]]:
        """Every switch as ``(tier, node)`` in deterministic order."""
        return [(t, v) for t, tier in enumerate(self.tiers)
                for v in range(tier.n_nodes)]

    def links(self) -> List[Tuple[Tuple, Tuple]]:
        """Every physical link as an ordered endpoint pair.

        Host attachments are ``(("host", h), (tier, node, port))``; switch-to-
        switch links are ``((t1, n1, p1), (t2, n2, p2))`` with the lower tier
        first.  Deterministic order — tests diff this structurally."""
        raise NotImplementedError

    def route(self, src: int, dst: int) -> Tuple[Hop, ...]:
        """The hop list a (src, dst) packet traverses.  Deterministic: equal-
        cost choices resolve by :func:`flow_hash`."""
        raise NotImplementedError

    # ----------------------------------------------------------- invariants
    def _check_host(self, h: int, role: str) -> None:
        if not 0 <= h < self.n_hosts:
            raise ValueError(f"{role} host {h} out of range for "
                             f"{self.kind} with {self.n_hosts} hosts")

    def validate_route(self, hops: Iterable[Hop]) -> None:
        """Structural sanity used by tests: every hop's ports fit its tier."""
        for hop in hops:
            tier = self.tiers[hop.tier]
            if not (0 <= hop.node < tier.n_nodes
                    and 0 <= hop.in_port < tier.degree
                    and 0 <= hop.out_port < tier.degree):
                raise ValueError(f"hop {hop} violates tier {tier}")

    def key(self) -> str:
        """Canonical content key (content-addressed serve caching)."""
        return json.dumps({"kind": self.kind, "params": self.params},
                          sort_keys=True)

    def __repr__(self) -> str:
        args = ", ".join(f"{k}={v}" for k, v in self.params.items())
        return f"{type(self).__name__}({args})"


class FatTree(Topology):
    """2-tier folded Clos from a k-ary fat-tree: ``k`` edge switches of ``k``
    ports (``k/2`` down to hosts, ``k/2`` up), ``k/2`` core switches of ``k``
    ports (one per edge switch, so both tiers share degree ``k``).
    ``k²/2`` hosts; inter-edge traffic ECMPs over the ``k/2`` cores."""

    kind = "fattree"

    def __init__(self, k: int = 4):
        if k < 2 or k % 2:
            raise ValueError(f"fattree needs an even k >= 2, got {k}")
        super().__init__({"k": k})
        self.k = k
        self.half = k // 2
        self.n_hosts = k * self.half
        self.tiers = (Tier("edge", k, k), Tier("core", self.half, k))

    @property
    def max_hops(self) -> int:
        return 3                     # intra-edge is 1 hop, via a core is 3

    def links(self):
        out = []
        for h in range(self.n_hosts):
            out.append((("host", h), (0, h // self.half, h % self.half)))
        for e in range(self.k):
            for c in range(self.half):
                out.append(((0, e, self.half + c), (1, c, e)))
        return out

    def route(self, src: int, dst: int) -> Tuple[Hop, ...]:
        self._check_host(src, "src")
        self._check_host(dst, "dst")
        e_s, p_s = divmod(src, self.half)
        e_d, p_d = divmod(dst, self.half)
        if e_s == e_d:
            return (Hop(0, e_s, p_s, p_d),)
        c = flow_hash(src, dst) % self.half
        return (Hop(0, e_s, p_s, self.half + c),
                Hop(1, c, e_s, e_d),
                Hop(0, e_d, self.half + c, p_d))


class LeafSpine(Topology):
    """Classic leaf/spine: ``leaves`` leaf switches with ``hosts_per_leaf``
    host ports + one uplink per spine (degree ``hosts_per_leaf + spines``);
    ``spines`` spine switches with one port per leaf (degree ``leaves``).
    Inter-leaf traffic ECMPs over the spines."""

    kind = "leafspine"

    def __init__(self, leaves: int = 2, spines: int = 2,
                 hosts_per_leaf: int = 4):
        if leaves < 1 or spines < 1 or hosts_per_leaf < 1:
            raise ValueError("leafspine needs leaves/spines/hosts_per_leaf >= 1")
        super().__init__({"leaves": leaves, "spines": spines,
                          "hosts_per_leaf": hosts_per_leaf})
        self.leaves, self.spines = leaves, spines
        self.hpl = hosts_per_leaf
        self.n_hosts = leaves * hosts_per_leaf
        self.tiers = (Tier("leaf", leaves, hosts_per_leaf + spines),
                      Tier("spine", spines, leaves))

    @property
    def max_hops(self) -> int:
        return 3 if self.leaves > 1 else 1

    def links(self):
        out = []
        for h in range(self.n_hosts):
            out.append((("host", h), (0, h // self.hpl, h % self.hpl)))
        for l in range(self.leaves):
            for s in range(self.spines):
                out.append(((0, l, self.hpl + s), (1, s, l)))
        return out

    def route(self, src: int, dst: int) -> Tuple[Hop, ...]:
        self._check_host(src, "src")
        self._check_host(dst, "dst")
        l_s, p_s = divmod(src, self.hpl)
        l_d, p_d = divmod(dst, self.hpl)
        if l_s == l_d:
            return (Hop(0, l_s, p_s, p_d),)
        s = flow_hash(src, dst) % self.spines
        return (Hop(0, l_s, p_s, self.hpl + s),
                Hop(1, s, l_s, l_d),
                Hop(0, l_d, self.hpl + s, p_d))


class Ring(Topology):
    """``n_nodes`` switches in a bidirectional ring, ``hosts_per_node`` hosts
    each.  Port layout per node: ``0..hosts_per_node-1`` hosts, then the
    counter-clockwise ring port and the clockwise ring port.  Shortest
    direction wins; exact ties resolve by flow hash."""

    kind = "ring"

    def __init__(self, n_nodes: int = 4, hosts_per_node: int = 2):
        if n_nodes < 1 or hosts_per_node < 1:
            raise ValueError("ring needs n_nodes/hosts_per_node >= 1")
        super().__init__({"n_nodes": n_nodes, "hosts_per_node": hosts_per_node})
        self.n_nodes, self.hpn = n_nodes, hosts_per_node
        self.n_hosts = n_nodes * hosts_per_node
        degree = hosts_per_node + (2 if n_nodes > 1 else 0)
        self.tiers = (Tier("ring", n_nodes, degree),)

    @property
    def max_hops(self) -> int:
        return 1 + self.n_nodes // 2

    @property
    def _ccw(self) -> int:           # local port towards node v-1
        return self.hpn

    @property
    def _cw(self) -> int:            # local port towards node v+1
        return self.hpn + 1

    def links(self):
        out = []
        for h in range(self.n_hosts):
            out.append((("host", h), (0, h // self.hpn, h % self.hpn)))
        if self.n_nodes > 1:
            for v in range(self.n_nodes):
                w = (v + 1) % self.n_nodes
                out.append(((0, v, self._cw), (0, w, self._ccw)))
        return out

    def route(self, src: int, dst: int) -> Tuple[Hop, ...]:
        self._check_host(src, "src")
        self._check_host(dst, "dst")
        a, p_s = divmod(src, self.hpn)
        b, p_d = divmod(dst, self.hpn)
        if a == b:
            return (Hop(0, a, p_s, p_d),)
        n = self.n_nodes
        d_cw = (b - a) % n
        d_ccw = (a - b) % n
        if d_cw == d_ccw:
            clockwise = bool(flow_hash(src, dst) & 1)
        else:
            clockwise = d_cw < d_ccw
        step = 1 if clockwise else -1
        out_ring = self._cw if clockwise else self._ccw
        in_ring = self._ccw if clockwise else self._cw
        hops = [Hop(0, a, p_s, out_ring)]
        v = (a + step) % n
        while v != b:
            hops.append(Hop(0, v, in_ring, out_ring))
            v = (v + step) % n
        hops.append(Hop(0, b, in_ring, p_d))
        return tuple(hops)


TOPOLOGY_KINDS: Dict[str, type] = {
    FatTree.kind: FatTree,
    LeafSpine.kind: LeafSpine,
    Ring.kind: Ring,
}


def build_topology(kind: str, **params: int) -> Topology:
    cls = TOPOLOGY_KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown topology kind {kind!r}; "
                         f"known: {', '.join(sorted(TOPOLOGY_KINDS))}")
    return cls(**params)


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """The serializable half of a topology (``Scenario.topology``).

    ``params`` is a sorted tuple of ``(name, value)`` pairs so the spec is
    hashable and its JSON form canonical."""

    kind: str
    params: Tuple[Tuple[str, int], ...] = ()

    def __post_init__(self):
        if self.kind not in TOPOLOGY_KINDS:
            raise ValueError(f"unknown topology kind {self.kind!r}; "
                             f"known: {', '.join(sorted(TOPOLOGY_KINDS))}")
        norm = tuple(sorted((str(k), int(v)) for k, v in self.params))
        object.__setattr__(self, "params", norm)
        self.build()                 # fail on bad params at spec time

    @classmethod
    def make(cls, kind: str, **params: int) -> "TopologySpec":
        return cls(kind=kind, params=tuple(params.items()))

    def build(self) -> Topology:
        return build_topology(self.kind, **dict(self.params))

    def to_dict(self) -> Dict:
        return {"kind": self.kind, "params": dict(self.params)}

    @staticmethod
    def from_dict(d: Mapping) -> "TopologySpec":
        return TopologySpec(kind=d["kind"],
                            params=tuple(dict(d.get("params", {})).items()))

    def key(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)
