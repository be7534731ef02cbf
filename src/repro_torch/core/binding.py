"""Semantic binding (§III-A): map protocol bit-fields to switch roles.

``routing_key`` is mandatory (the paper: "the protocol field designated for
routing must be specified, while other fields remain optional").  The binding
stage performs key-value matching over the protocol's semantic aliases and
emits a ``BoundProtocol`` — the analogue of the generated ``packet.hpp`` —
which downstream consumers (switch parser, netsim driver, Pallas kernel
generator) read instead of the raw protocol.  This is what decouples protocol
layout from switching logic: change the layout, re-bind, nothing downstream
changes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from .dsl import Field, ParserPlan, Protocol

__all__ = ["SemanticBinding", "BoundProtocol", "bind"]

#: semantics the switch understands.  routing_key is required.
KNOWN_SEMANTICS = ("routing_key", "src_key", "qos", "length", "seq_no", "opcode", "payload_tag")


@dataclasses.dataclass(frozen=True)
class SemanticBinding:
    """Explicit field-name overrides; fields left None are resolved by alias."""

    routing_key: Optional[str] = None
    src_key: Optional[str] = None
    qos: Optional[str] = None
    length: Optional[str] = None
    seq_no: Optional[str] = None
    opcode: Optional[str] = None
    payload_tag: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class BoundProtocol:
    """A protocol + resolved semantic map + compiled parser plan.

    The single artifact handed to the switch generator (role of packet.hpp).
    """

    protocol: Protocol
    semantics: Dict[str, str]  # semantic -> field name
    plan: ParserPlan

    # convenience accessors -------------------------------------------------
    def _field(self, semantic: str) -> Field:
        try:
            return self.protocol.field(self.semantics[semantic])
        except KeyError as e:
            raise KeyError(f"protocol {self.protocol.name!r} has no bound {semantic!r}") from e

    @property
    def routing_field(self) -> Field:
        return self._field("routing_key")

    @property
    def src_field(self) -> Field:
        return self._field("src_key")

    @property
    def addr_bits(self) -> int:
        return self.routing_field.bits

    def has(self, semantic: str) -> bool:
        return semantic in self.semantics

    @property
    def header_bytes(self) -> int:
        return self.protocol.header_bytes

    def describe(self) -> str:
        lines = [f"BoundProtocol {self.protocol.name} ({self.protocol.header_bits} header bits)"]
        for sem, fname in sorted(self.semantics.items()):
            f = self.protocol.field(fname)
            lines.append(f"  {sem:12s} -> {fname} [{f.bits}b @ bit {self.protocol.offset_of(fname)}]")
        if self.plan.straddling_fields:
            lines.append(f"  straddlers @ {self.plan.flit_bits}b flits: {list(self.plan.straddling_fields)}")
        return "\n".join(lines)


def bind(
    protocol: Protocol,
    binding: Optional[SemanticBinding] = None,
    *,
    flit_bits: int = 256,
) -> BoundProtocol:
    """Resolve semantics by explicit override first, then by field alias."""
    if binding is None:
        binding = SemanticBinding()
    resolved: Dict[str, str] = {}
    for sem in KNOWN_SEMANTICS:
        override = getattr(binding, sem, None)
        if override is not None:
            if override not in {f.name for f in protocol.fields}:
                raise ValueError(f"binding {sem}={override!r}: no such field in {protocol.name!r}")
            resolved[sem] = override
            continue
        aliased = protocol.fields_by_semantic(sem)
        if len(aliased) > 1:
            raise ValueError(
                f"protocol {protocol.name!r}: multiple fields alias {sem!r}: "
                f"{[f.name for f in aliased]} — disambiguate via SemanticBinding"
            )
        if aliased:
            resolved[sem] = aliased[0].name
    if "routing_key" not in resolved:
        raise ValueError(
            f"protocol {protocol.name!r}: routing_key is mandatory (alias a field with "
            "semantic='routing_key' or pass SemanticBinding(routing_key=...))"
        )
    return BoundProtocol(protocol=protocol, semantics=resolved, plan=protocol.compile(flit_bits))
