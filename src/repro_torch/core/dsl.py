"""SPAC protocol DSL — NetBlocks-compatible bit-level packet layout.

The paper (§III-A) uses NetBlocks syntax to declare custom protocols with
bit-level serialization.  A ``Protocol`` here is the single source of truth
consumed by

  * the switch parser generator (compile-time bit offsets, straddle detection,
    ``src/repro/switch/parser.py`` and the Pallas kernel generator in
    ``src/repro/kernels/parser``),
  * the network simulator (header/payload serialization delay),
  * the DSE engine (S_min, header overhead),
  * and the TPU comm layer (message layouts for gradient buckets / MoE
    dispatch payloads reuse the same Field/Protocol machinery).

Layout rules mirror NetBlocks: fields are packed MSB-first, back to back, with
no implicit alignment.  ``Protocol.compile(flit_bits)`` reproduces the paper's
"template metaprogramming" stage: it recursively computes the exact bit offset
of every field relative to flit boundaries and detects fields that straddle
word boundaries (which need state retention in hardware).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "Field",
    "FieldSpec",
    "Protocol",
    "ProtocolSpace",
    "FieldSlice",
    "ParserPlan",
    "ethernet_ipv4_udp",
    "compressed_protocol",
    "compressed_protocol_space",
    "layout_key",
    "ETHERNET_HEADER_BYTES",
]

# A standard Ethernet+IPv4+UDP stack costs 42 B of header (the paper's §II-B
# "at least 42B" figure): 14 (Eth) + 20 (IPv4) + 8 (UDP).
ETHERNET_HEADER_BYTES = 42


@dataclasses.dataclass(frozen=True)
class Field:
    """One bit-field of a protocol header.

    ``bits`` is the exact width; ``semantic`` is the optional alias used by
    semantic binding (§III-A), e.g. ``routing_key`` / ``src_key`` / ``qos`` /
    ``length`` / ``seq_no`` / ``opcode``.
    """

    name: str
    bits: int
    semantic: Optional[str] = None
    default: int = 0

    def __post_init__(self):
        if self.bits <= 0 or self.bits > 64:
            raise ValueError(f"field {self.name!r}: bits must be in [1, 64], got {self.bits}")


@dataclasses.dataclass(frozen=True)
class FieldSlice:
    """Where a (piece of a) field lives relative to flit boundaries.

    ``word`` indexes the flit, ``hi``/``lo`` are bit positions inside the flit
    (MSB-first, ``hi`` inclusive, ``lo`` inclusive, hi >= lo).  A field that
    straddles a flit boundary compiles to >1 slice — the hardware then needs
    minimal state retention, exactly the paper's straddle handling.
    """

    field: str
    word: int
    hi: int
    lo: int
    dst_shift: int  # how far left (in bits) this piece sits inside the value


@dataclasses.dataclass(frozen=True)
class ParserPlan:
    """Compile-time parsing plan for a given flit width (§III-B.1)."""

    flit_bits: int
    header_bits: int
    slices: Tuple[FieldSlice, ...]
    straddling_fields: Tuple[str, ...]

    @property
    def header_flits(self) -> int:
        return -(-self.header_bits // self.flit_bits)

    def slices_for(self, name: str) -> List[FieldSlice]:
        return [s for s in self.slices if s.field == name]


class Protocol:
    """An ordered sequence of bit-fields followed by a variable payload."""

    def __init__(self, name: str, fields: Sequence[Field]):
        names = [f.name for f in fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate field names in protocol {name!r}")
        self.name = name
        self.fields: Tuple[Field, ...] = tuple(fields)
        self._by_name: Dict[str, Field] = {f.name: f for f in fields}
        offs: Dict[str, int] = {}
        off = 0
        for f in fields:
            offs[f.name] = off
            off += f.bits
        self._offsets = offs
        self.header_bits = off

    # ------------------------------------------------------------------ meta
    @property
    def header_bytes(self) -> int:
        return -(-self.header_bits // 8)

    def field(self, name: str) -> Field:
        return self._by_name[name]

    def offset_of(self, name: str) -> int:
        return self._offsets[name]

    def fields_by_semantic(self, semantic: str) -> List[Field]:
        return [f for f in self.fields if f.semantic == semantic]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Protocol({self.name!r}, header={self.header_bits}b)"

    # --------------------------------------------------------------- compile
    def compile(self, flit_bits: int) -> ParserPlan:
        """Lower the layout to flit-relative bit slices (paper §III-B.1)."""
        if flit_bits <= 0 or flit_bits % 8:
            raise ValueError("flit_bits must be a positive multiple of 8")
        slices: List[FieldSlice] = []
        straddlers: List[str] = []
        for f in self.fields:
            start = self._offsets[f.name]
            end = start + f.bits  # exclusive
            w0, w1 = start // flit_bits, (end - 1) // flit_bits
            if w0 != w1:
                straddlers.append(f.name)
            remaining = f.bits
            pos = start
            while remaining > 0:
                w = pos // flit_bits
                in_word = pos - w * flit_bits
                take = min(remaining, flit_bits - in_word)
                # MSB-first: bit 0 of the stream is the MSB of flit word 0.
                hi = flit_bits - 1 - in_word
                lo = hi - take + 1
                slices.append(
                    FieldSlice(field=f.name, word=w, hi=hi, lo=lo, dst_shift=remaining - take)
                )
                pos += take
                remaining -= take
        return ParserPlan(
            flit_bits=flit_bits,
            header_bits=self.header_bits,
            slices=tuple(slices),
            straddling_fields=tuple(straddlers),
        )

    # --------------------------------------------------------- (de)serialize
    def pack(self, values: Dict[str, int], payload: bytes = b"") -> bytes:
        """Bit-exact serializer (numpy bit ops; ``pack_reference`` is the
        per-bit oracle it is tested against)."""
        bits = np.zeros(self.header_bytes * 8, dtype=np.uint8)
        for f in self.fields:
            v = int(values.get(f.name, f.default))
            if v < 0 or v >= (1 << f.bits):
                raise ValueError(f"value {v} out of range for field {f.name} ({f.bits}b)")
            start = self._offsets[f.name]
            shifts = np.arange(f.bits - 1, -1, -1, dtype=np.uint64)
            bits[start:start + f.bits] = (
                (np.uint64(v) >> shifts) & np.uint64(1)).astype(np.uint8)
        return np.packbits(bits).tobytes() + payload

    def unpack(self, data: bytes) -> Dict[str, int]:
        """Bit-exact deserializer (numpy bit ops, inverse of :meth:`pack`)."""
        arr = np.frombuffer(data, dtype=np.uint8)
        if arr.size < self.header_bytes:
            raise ValueError(
                f"protocol {self.name!r}: header needs {self.header_bytes} "
                f"bytes, got {arr.size}")
        bits = np.unpackbits(arr[:self.header_bytes])
        out: Dict[str, int] = {}
        for f in self.fields:
            start = self._offsets[f.name]
            packed = np.packbits(bits[start:start + f.bits]).tobytes()
            # packbits zero-pads the tail byte on the right (low bits)
            out[f.name] = int.from_bytes(packed, "big") >> ((-f.bits) % 8)
        return out

    # ----------------------------------------------- per-bit reference oracle
    def pack_reference(self, values: Dict[str, int], payload: bytes = b"") -> bytes:
        """The original O(header_bits) per-bit serializer, kept as the oracle
        the vectorized :meth:`pack` is regression-tested against."""
        nbytes = self.header_bytes
        buf = np.zeros(nbytes, dtype=np.uint8)
        for f in self.fields:
            v = int(values.get(f.name, f.default))
            if v < 0 or v >= (1 << f.bits):
                raise ValueError(f"value {v} out of range for field {f.name} ({f.bits}b)")
            start = self._offsets[f.name]
            for b in range(f.bits):
                bit = (v >> (f.bits - 1 - b)) & 1
                pos = start + b
                if bit:
                    buf[pos // 8] |= 1 << (7 - pos % 8)
        return bytes(buf) + payload

    def unpack_reference(self, data: bytes) -> Dict[str, int]:
        """Per-bit deserializer oracle (see :meth:`pack_reference`)."""
        arr = np.frombuffer(data, dtype=np.uint8)
        out: Dict[str, int] = {}
        for f in self.fields:
            start = self._offsets[f.name]
            v = 0
            for b in range(f.bits):
                pos = start + b
                bit = (arr[pos // 8] >> (7 - pos % 8)) & 1
                v = (v << 1) | int(bit)
            out[f.name] = v
        return out

    def wire_bytes(self, payload_bytes: int) -> int:
        """Total on-wire size for a packet with the given payload."""
        return self.header_bytes + int(payload_bytes)


# --------------------------------------------------------------------------
# Stock protocols
# --------------------------------------------------------------------------

def ethernet_ipv4_udp() -> Protocol:
    """The general-purpose 42 B header stack the paper compresses away."""
    return Protocol(
        "ethernet_ipv4_udp",
        [
            Field("eth_dst", 48, semantic="routing_key"),
            Field("eth_src", 48, semantic="src_key"),
            Field("eth_type", 16),
            Field("ip_ver_ihl", 8),
            Field("ip_tos", 8, semantic="qos"),
            Field("ip_len", 16, semantic="length"),
            Field("ip_id", 16),
            Field("ip_flags_frag", 16),
            Field("ip_ttl", 8),
            Field("ip_proto", 8),
            Field("ip_csum", 16),
            Field("ip_src", 32),
            Field("ip_dst", 32),
            Field("udp_src", 16),
            Field("udp_dst", 16),
            Field("udp_len", 16),
            Field("udp_csum", 16),
        ],
    )


# --------------------------------------------------------------------------
# Protocol as a *space* (co-design, §III-A + Table II's adaptive headers)
# --------------------------------------------------------------------------

#: canonical per-field layout identity: (name, bits, semantic, default)
LayoutKey = Tuple[Tuple[str, int, Optional[str], int], ...]


def address_width_error(semantic: str, field_name: str, bits: int,
                        n_ports: int) -> Optional[str]:
    """One home for the address-sizing rule: a routing/src field of ``bits``
    must span ``n_ports``.  Returns the reason string, or None when wide
    enough.  Shared by ``ProtocolSpace.feasible`` (co-design stage-1 prune)
    and the scenario-build validation of fixed protocols, so the rule and
    its wording cannot drift."""
    if (1 << bits) < n_ports:
        need = max(1, (n_ports - 1).bit_length())
        return (f"{semantic} field {field_name!r} is {bits} bits "
                f"(addresses {1 << bits} ports) but n_ports={n_ports} "
                f"needs >= {need} bits")
    return None


def layout_key(protocol: Protocol) -> LayoutKey:
    """Canonical, hashable identity of a protocol *layout* (name-independent).

    Two protocols with the same field sequence — names, widths, semantics,
    defaults — get the same key regardless of the protocol's display name;
    the co-design DSE memoizes compiled ``ParserPlan``s/bindings on it."""
    return tuple((f.name, f.bits, f.semantic, f.default) for f in protocol.fields)


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """One bit-field whose width is a *choice set* rather than a point.

    ``bits`` lists the candidate widths the co-design search may pick from;
    a width of 0 drops the field entirely (optional fields).  A plain
    ``Field`` is the single-choice degenerate case (``FieldSpec.fixed``).
    """

    name: str
    bits: Tuple[int, ...]
    semantic: Optional[str] = None
    default: int = 0

    def __post_init__(self):
        choices = tuple(int(b) for b in self.bits)
        if not choices:
            raise ValueError(f"field spec {self.name!r} has no width choices")
        if len(set(choices)) != len(choices):
            raise ValueError(f"field spec {self.name!r}: duplicate width choices {choices}")
        for b in choices:
            if b < 0 or b > 64:
                raise ValueError(
                    f"field spec {self.name!r}: widths must be in [0, 64], got {b}")
        if max(choices) == 0:
            raise ValueError(
                f"field spec {self.name!r} is always dropped (all widths 0); omit it")
        object.__setattr__(self, "bits", choices)

    @staticmethod
    def fixed(field: Field) -> "FieldSpec":
        """Capture a concrete ``Field`` as a single-choice spec."""
        return FieldSpec(field.name, (field.bits,), field.semantic, field.default)

    @property
    def searchable(self) -> bool:
        return len(self.bits) > 1


class ProtocolSpace:
    """A protocol as a *search space*: per-field width choices.

    Where ``Protocol`` is one point (the classic DSL), a ``ProtocolSpace``
    spans the joint layout space the paper's co-design explores: every field
    carries a finite width choice set (0 = drop the field), ``decode`` lowers
    one width assignment to a concrete ``Protocol``, ``enumerate`` walks the
    whole space, and ``feasible`` applies the stage-1 static rules (the
    routing/src key must address every port, a variable payload needs a
    length field wide enough for the largest packet, retransmission needs a
    sequence number).  ``dims()`` is what the DSE splices into the NSGA-II
    genome next to the architecture genes.
    """

    def __init__(self, name: str, fields: Sequence[FieldSpec]):
        fields = tuple(f if isinstance(f, FieldSpec) else FieldSpec.fixed(f)
                       for f in fields)
        names = [f.name for f in fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate field names in protocol space {name!r}")
        if not fields:
            raise ValueError(f"protocol space {name!r} has no fields")
        self.name = name
        self.fields: Tuple[FieldSpec, ...] = tuple(fields)
        self._by_name: Dict[str, FieldSpec] = {f.name: f for f in fields}

    # ------------------------------------------------------------------ meta
    def field(self, name: str) -> FieldSpec:
        return self._by_name[name]

    def fields_by_semantic(self, semantic: str) -> List[FieldSpec]:
        return [f for f in self.fields if f.semantic == semantic]

    def dims(self) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
        """(field name, width choices) per field, in layout order — the
        protocol genes a ``DesignSpace`` splices into the search genome."""
        return tuple((f.name, f.bits) for f in self.fields)

    def size(self) -> int:
        n = 1
        for f in self.fields:
            n *= len(f.bits)
        return n

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ProtocolSpace({self.name!r}, {self.size()} layouts)"

    # ---------------------------------------------------------------- decode
    def _widths(self, widths: Union[Mapping[str, int], Sequence[int]]) -> Dict[str, int]:
        if isinstance(widths, Mapping):
            out = {f.name: int(widths[f.name]) for f in self.fields}
        else:
            if len(widths) != len(self.fields):
                raise ValueError(
                    f"protocol space {self.name!r} has {len(self.fields)} "
                    f"fields, got {len(widths)} widths")
            out = {f.name: int(w) for f, w in zip(self.fields, widths)}
        for f in self.fields:
            if out[f.name] not in f.bits:
                raise ValueError(
                    f"field {f.name!r}: width {out[f.name]} not among the "
                    f"choices {f.bits}")
        return out

    def decode(self, widths: Union[Mapping[str, int], Sequence[int]]) -> Protocol:
        """One width assignment -> a concrete ``Protocol`` (0-width fields
        dropped).  The decoded name encodes the layout, e.g.
        ``spac_hft/dst4-src4-len12``, so reports and golden snapshots carry
        the winning layout as a plain string."""
        w = self._widths(widths)
        kept = [(f, w[f.name]) for f in self.fields if w[f.name] > 0]
        tag = "-".join(f"{f.name}{bits}" for f, bits in kept) or "empty"
        return Protocol(
            f"{self.name}/{tag}",
            [Field(f.name, bits, f.semantic, f.default) for f, bits in kept])

    def layout_key(self, widths: Union[Mapping[str, int], Sequence[int]]) -> LayoutKey:
        """Canonical hashable key of one assignment (dropped fields elided) —
        equals ``layout_key(self.decode(widths))`` without building anything."""
        w = self._widths(widths)
        return tuple((f.name, w[f.name], f.semantic, f.default)
                     for f in self.fields if w[f.name] > 0)

    def max_widths(self) -> Dict[str, int]:
        """The widest point of the space (always bindable if any point is)."""
        return {f.name: max(f.bits) for f in self.fields}

    def enumerate(self) -> Iterator[Protocol]:
        """Every concrete layout of the space, row-major in choice order."""
        for combo in itertools.product(*(f.bits for f in self.fields)):
            yield self.decode(combo)

    # ----------------------------------------------------- static feasibility
    def feasible(
        self,
        widths: Union[Mapping[str, int], Sequence[int]],
        *,
        n_ports: Optional[int] = None,
        max_payload_bytes: Optional[int] = None,
        variable_payload: bool = False,
        needs_seq: bool = False,
    ) -> Optional[str]:
        """Stage-1 static feasibility of one layout; None = feasible, else a
        human-readable reason.

        Rules (paper §III-A): the routing key must exist and, with ``src_key``,
        be wide enough to address ``n_ports``; a variable-size payload needs a
        length field that can represent ``max_payload_bytes``; retransmission
        (``needs_seq``) requires a sequence-number field.
        """
        w = self._widths(widths)
        for sem in ("routing_key", "src_key"):
            for f in self.fields_by_semantic(sem):
                bits = w[f.name]
                if bits == 0:
                    if sem == "routing_key":
                        return f"routing field {f.name!r} dropped (width 0)"
                    continue                       # src may be dropped
                if n_ports is not None:
                    err = address_width_error(sem, f.name, bits, n_ports)
                    if err is not None:
                        return err
        if not self.fields_by_semantic("routing_key"):
            return "protocol space has no routing_key field"
        len_fields = self.fields_by_semantic("length")
        len_bits = max((w[f.name] for f in len_fields), default=0)
        if variable_payload and len_bits == 0:
            return "variable-size payload needs a length field (all dropped)"
        if len_bits > 0 and max_payload_bytes is not None \
                and (1 << len_bits) - 1 < max_payload_bytes:
            return (f"length field is {len_bits} bits (max "
                    f"{(1 << len_bits) - 1}) but the trace's max payload is "
                    f"{max_payload_bytes} B")
        if needs_seq:
            seq_bits = max((w[f.name] for f in self.fields_by_semantic("seq_no")),
                           default=0)
            if seq_bits == 0:
                return "retransmission needs a seq_no field (dropped or absent)"
        return None


#: default co-design width menus (Table II territory: 4b addresses up to the
#: full 16b datacenter-scale keys; 0 drops the optional field entirely)
CODESIGN_ADDR_CHOICES: Tuple[int, ...] = (4, 8, 16)
CODESIGN_QOS_CHOICES: Tuple[int, ...] = (0, 2, 4)
CODESIGN_LENGTH_CHOICES: Tuple[int, ...] = (0, 6, 12, 16)
CODESIGN_SEQ_CHOICES: Tuple[int, ...] = (0, 8, 16)


def compressed_protocol_space(
    name: str = "spac_compressed",
    addr_bits: Union[int, Sequence[int]] = CODESIGN_ADDR_CHOICES,
    qos_bits: Union[int, Sequence[int]] = CODESIGN_QOS_CHOICES,
    length_bits: Union[int, Sequence[int]] = CODESIGN_LENGTH_CHOICES,
    seq_bits: Union[int, Sequence[int]] = CODESIGN_SEQ_CHOICES,
    extra_fields: Sequence[Field] = (),
) -> ProtocolSpace:
    """The ``compressed_protocol`` family as a space: every width parameter
    may be a scalar (pinned) or a choice sequence (searched).  ``dst`` and
    ``src`` draw from the same ``addr_bits`` menu but are independent genes
    (the paper's 2 B header uses 4b+4b; asymmetric splits are legal)."""
    def choices(v) -> Tuple[int, ...]:
        return tuple(int(x) for x in v) if isinstance(v, (tuple, list)) else (int(v),)

    addr, qos, ln, seq = (choices(v) for v in (addr_bits, qos_bits, length_bits, seq_bits))
    fields: List[FieldSpec] = [
        FieldSpec("dst", addr, "routing_key"),
        FieldSpec("src", addr, "src_key"),
    ]
    for fname, sem, cs in (("qos", "qos", qos), ("len", "length", ln),
                           ("seq", "seq_no", seq)):
        if cs != (0,):                 # pinned-to-0 == omitted (builder parity)
            fields.append(FieldSpec(fname, cs, sem))
    fields.extend(FieldSpec.fixed(f) for f in extra_fields)
    return ProtocolSpace(name, fields)


def compressed_protocol(
    name: str = "spac_compressed",
    addr_bits: int = 4,
    qos_bits: int = 2,
    length_bits: int = 6,
    seq_bits: int = 0,
    extra_fields: Sequence[Field] = (),
) -> Protocol:
    """SPAC/NetBlocks-style shrunk protocol (e.g. the 2 B underwater header).

    Default = 4b dst + 4b src + 2b qos + 6b length = 16 bits = 2 bytes,
    matching Table II's ``Avg Header = 2`` rows.
    """
    fields: List[Field] = [
        Field("dst", addr_bits, semantic="routing_key"),
        Field("src", addr_bits, semantic="src_key"),
    ]
    if qos_bits:
        fields.append(Field("qos", qos_bits, semantic="qos"))
    if length_bits:
        fields.append(Field("len", length_bits, semantic="length"))
    if seq_bits:
        fields.append(Field("seq", seq_bits, semantic="seq_no"))
    fields.extend(extra_fields)
    return Protocol(name, fields)
