"""Capture ingestion: pcap/CSV → ``Trace`` through declarative stages.

Real captures enter the DSE here.  A reader parses the container format
(classic libpcap via stdlib ``struct``, or CSV) into the raw packet arrays,
then a ``Pipeline`` of declarative, composable stages massages them into a
simulation-ready ``Trace`` — filter, remap ports, rescale time, clip — plus
*generative stressors* (incast storm, Zipf drift, diurnal load) that
synthesise adversarial traffic on top of the capture.  Pipelines are data:
``to_dict``/``from_dict`` round-trip them, stage application order is the
tuple order (order-deterministic by construction), and every stochastic
stage draws from a generator seeded by ``(pipeline seed, stage index)`` so
one seed reproduces the whole pipeline regardless of which stages surround
a stressor.

    tr = ingest("capture.csv",
                pipeline=Pipeline(seed=7)
                    .then("filter", min_payload=64)
                    .then("remap_ports", n_ports=8)
                    .then("incast", dst=0, n_senders=6)
                    .then("rescale_time", factor=0.5))
    tr.save("capture.npz")     # → TraceSpec(path="capture.npz") in a Scenario

The port's copy of the JAX package's ``traces/ingest.py`` (NumPy and
``struct`` only; on the same files, stages and seeds it gives the same
traces).
"""

from __future__ import annotations

import csv
import dataclasses
import math
import struct
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np

from .base import Trace

__all__ = ["IngestError", "Pipeline", "Stage", "STAGES", "ingest",
           "read_csv", "read_pcap", "write_pcap"]


class IngestError(ValueError):
    """Malformed capture or pipeline — ``python -m repro_torch ingest`` maps
    this to exit 2."""


# --------------------------------------------------------------------------
# readers
# --------------------------------------------------------------------------

_CSV_COLUMNS = ("time_s", "src", "dst", "payload_bytes")


def read_csv(path, *, name: Optional[str] = None, n_ports: Optional[int] = None,
             link_gbps: float = 100.0) -> Trace:
    """CSV → ``Trace``.  Accepts a header row naming (any superset of)
    ``time_s, src, dst, payload_bytes`` in any order, or headerless rows in
    exactly that positional order."""
    path = Path(path)
    try:
        with open(path, newline="") as fh:
            rows = [r for r in csv.reader(fh) if r and any(f.strip() for f in r)]
    except OSError as e:
        raise IngestError(f"cannot read {path}: {e}") from e
    if not rows:
        raise IngestError(f"{path}: empty capture")

    def _numeric(field: str) -> bool:
        try:
            float(field)
            return True
        except ValueError:
            return False

    first = [f.strip() for f in rows[0]]
    if all(_numeric(f) for f in first):
        cols = {c: i for i, c in enumerate(_CSV_COLUMNS)}
        body = rows
    else:
        cols = {c.strip(): i for i, c in enumerate(first)}
        missing = [c for c in _CSV_COLUMNS if c not in cols]
        if missing:
            raise IngestError(
                f"{path}: header is missing column(s) {missing}; "
                f"need {list(_CSV_COLUMNS)} (extra columns are ignored)")
        body = rows[1:]
    if not body:
        raise IngestError(f"{path}: no packet rows")

    time_s, src, dst, payload = [], [], [], []
    for ln, row in enumerate(body, start=1):
        try:
            time_s.append(float(row[cols["time_s"]]))
            src.append(int(row[cols["src"]]))
            dst.append(int(row[cols["dst"]]))
            payload.append(int(row[cols["payload_bytes"]]))
        except (ValueError, IndexError) as e:
            raise IngestError(f"{path}: bad row {ln}: {row!r} ({e})") from e
    return _make_trace(path.stem if name is None else name,
                       np.asarray(time_s), np.asarray(src), np.asarray(dst),
                       np.asarray(payload), n_ports, link_gbps)


#: classic-pcap magic → (byte order, fraction-of-second unit in ns)
_PCAP_MAGICS = {
    0xA1B2C3D4: ("<", 1000), 0xD4C3B2A1: (">", 1000),     # microsecond
    0xA1B23C4D: ("<", 1), 0x4D3CB2A1: (">", 1),           # nanosecond
}
_LINKTYPE_ETHERNET = 1
_ETHERTYPE_IPV4 = 0x0800


def read_pcap(path, *, name: Optional[str] = None, n_ports: Optional[int] = None,
              link_gbps: float = 100.0) -> Trace:
    """Classic libpcap → ``Trace`` (stdlib ``struct``; no capture library).

    Ethernet + IPv4 frames only; a packet's host id is the low 16 bits of
    its IPv4 address (deterministic — no first-seen renumbering), so ingest
    of the same capture always yields the same ids; use the ``remap_ports``
    stage to fold a real address plan onto the simulated port space.  The
    payload is the frame's original (untruncated) wire length; timestamps
    convert through one integer-nanosecond value so they are reproducible to
    the bit."""
    path = Path(path)
    try:
        data = path.read_bytes()
    except OSError as e:
        raise IngestError(f"cannot read {path}: {e}") from e
    if len(data) < 24:
        raise IngestError(f"{path}: truncated pcap global header")
    magic = struct.unpack("<I", data[:4])[0]
    if magic not in _PCAP_MAGICS:
        magic = struct.unpack(">I", data[:4])[0]
    if magic not in _PCAP_MAGICS:
        raise IngestError(f"{path}: not a classic pcap (magic {magic:#x}); "
                          f"pcapng is not supported — convert with tshark")
    order, frac_ns = _PCAP_MAGICS[magic]
    linktype = struct.unpack(order + "I", data[20:24])[0]
    if linktype != _LINKTYPE_ETHERNET:
        raise IngestError(f"{path}: linktype {linktype} unsupported "
                          f"(need Ethernet = {_LINKTYPE_ETHERNET})")

    time_s, src, dst, payload = [], [], [], []
    off, skipped = 24, 0
    while off < len(data):
        if off + 16 > len(data):
            raise IngestError(f"{path}: truncated record header at {off}")
        sec, frac, incl, orig = struct.unpack(order + "IIII", data[off:off + 16])
        off += 16
        if off + incl > len(data):
            raise IngestError(f"{path}: truncated packet record at {off}")
        frame = data[off:off + incl]
        off += incl
        # Ethernet(14) + IPv4 header up to the addresses (34 bytes)
        if len(frame) < 34 or struct.unpack(">H", frame[12:14])[0] != _ETHERTYPE_IPV4:
            skipped += 1
            continue
        time_s.append((sec * 10**9 + frac * frac_ns) * 1e-9)
        src.append(struct.unpack(">H", frame[28:30])[0])
        dst.append(struct.unpack(">H", frame[32:34])[0])
        payload.append(orig)
    if not time_s:
        raise IngestError(f"{path}: no Ethernet/IPv4 packets "
                          f"({skipped} frames skipped)")
    return _make_trace(path.stem if name is None else name,
                       np.asarray(time_s), np.asarray(src), np.asarray(dst),
                       np.asarray(payload), n_ports, link_gbps)


def write_pcap(path, time_ns: Iterable[int], src: Iterable[int],
               dst: Iterable[int], payload_bytes: Iterable[int]) -> None:
    """Synthesise a minimal nanosecond classic pcap (Ethernet + IPv4 + UDP).

    The inverse convention of :func:`read_pcap`: host id h becomes IPv4
    ``10.0.(h>>8).(h&255)`` and ``payload_bytes`` becomes the record's
    original length (the stored frame is header-only, a legal snaplen
    truncation) — so write → read round-trips ids, times and sizes exactly.
    Test/fixture helper; real captures come from real taps."""
    out = bytearray()
    out += struct.pack("<IHHiIII", 0xA1B23C4D, 2, 4, 0, 0, 65535,
                       _LINKTYPE_ETHERNET)
    for t, s, d, p in zip(time_ns, src, dst, payload_bytes):
        t, s, d, p = int(t), int(s), int(d), int(p)
        ip = struct.pack(">BBHHHBBH", 0x45, 0, 28, 0, 0, 64, 17, 0)
        ip += bytes((10, 0, (s >> 8) & 0xFF, s & 0xFF))
        ip += bytes((10, 0, (d >> 8) & 0xFF, d & 0xFF))
        udp = struct.pack(">HHHH", 4000, 4000, 8, 0)
        frame = b"\x02" * 6 + b"\x04" * 6 + struct.pack(">H", _ETHERTYPE_IPV4) + ip + udp
        out += struct.pack("<IIII", t // 10**9, t % 10**9, len(frame), p)
        out += frame
    Path(path).write_bytes(bytes(out))


def _make_trace(name, time_s, src, dst, payload, n_ports, link_gbps) -> Trace:
    if np.any(payload < 0):
        raise IngestError(f"{name}: negative payload_bytes")
    if np.any(src < 0) or np.any(dst < 0):
        raise IngestError(f"{name}: negative port ids")
    inferred = int(max(src.max(), dst.max())) + 1 if src.size else 1
    if n_ports is None:
        n_ports = inferred
    elif inferred > n_ports:
        raise IngestError(
            f"{name}: port id {inferred - 1} out of range for "
            f"n_ports={n_ports} (add a remap_ports stage or raise n_ports)")
    return Trace(name=name, time_s=time_s.astype(np.float64),
                 src=src.astype(np.int32), dst=dst.astype(np.int32),
                 payload_bytes=payload.astype(np.int64),
                 n_ports=int(n_ports), link_gbps=float(link_gbps))


# --------------------------------------------------------------------------
# stages
# --------------------------------------------------------------------------

def _stage_filter(tr: Trace, rng: np.random.Generator, *,
                  min_payload: Optional[int] = None,
                  max_payload: Optional[int] = None,
                  t_start: Optional[float] = None,
                  t_stop: Optional[float] = None,
                  ports: Optional[Iterable[int]] = None) -> Trace:
    """Keep packets matching every given predicate."""
    keep = np.ones(len(tr), bool)
    if min_payload is not None:
        keep &= tr.payload_bytes >= min_payload
    if max_payload is not None:
        keep &= tr.payload_bytes <= max_payload
    if t_start is not None:
        keep &= tr.time_s >= t_start
    if t_stop is not None:
        keep &= tr.time_s < t_stop
    if ports is not None:
        allowed = np.asarray(sorted(int(p) for p in ports), np.int64)
        keep &= np.isin(tr.src, allowed) & np.isin(tr.dst, allowed)
    return Trace(tr.name, tr.time_s[keep], tr.src[keep], tr.dst[keep],
                 tr.payload_bytes[keep], tr.n_ports, tr.link_gbps)


def _stage_remap_ports(tr: Trace, rng: np.random.Generator, *,
                       n_ports: Optional[int] = None,
                       mapping: Optional[Dict[Any, Any]] = None) -> Trace:
    """Fold endpoint ids onto the simulated port space: an explicit old→new
    ``mapping`` (unmapped ids raise), or modulo ``n_ports``."""
    if mapping is not None:
        lut: Dict[int, int] = {int(k): int(v) for k, v in mapping.items()}
        ids = np.union1d(np.unique(tr.src), np.unique(tr.dst))
        unmapped = [int(i) for i in ids if int(i) not in lut]
        if unmapped:
            raise IngestError(f"remap_ports: no mapping for ids {unmapped}")
        remap = np.vectorize(lut.__getitem__, otypes=[np.int64])
        src, dst = remap(tr.src), remap(tr.dst)
        np_new = n_ports if n_ports is not None else int(max(lut.values())) + 1
    else:
        if n_ports is None:
            raise IngestError("remap_ports needs n_ports or mapping")
        np_new = int(n_ports)
        src, dst = tr.src % np_new, tr.dst % np_new
    return Trace(tr.name, tr.time_s, src, dst, tr.payload_bytes,
                 np_new, tr.link_gbps)


def _stage_rescale_time(tr: Trace, rng: np.random.Generator, *,
                        factor: float = 1.0, origin: bool = False) -> Trace:
    """Compress (<1) or dilate (>1) the timeline; ``origin`` re-bases the
    first arrival to t=0."""
    if factor <= 0:
        raise IngestError(f"rescale_time factor must be > 0, got {factor}")
    t = tr.time_s * float(factor)
    if origin and t.size:
        t = t - t.min()
    return Trace(tr.name, t, tr.src, tr.dst, tr.payload_bytes,
                 tr.n_ports, tr.link_gbps)


def _stage_clip(tr: Trace, rng: np.random.Generator, *,
                max_packets: Optional[int] = None,
                duration_s: Optional[float] = None) -> Trace:
    """Bound the trace: at most ``duration_s`` after the first arrival
    and/or the first ``max_packets`` packets."""
    out = tr
    if duration_s is not None and len(out):
        keep = out.time_s < out.time_s.min() + duration_s
        out = Trace(out.name, out.time_s[keep], out.src[keep], out.dst[keep],
                    out.payload_bytes[keep], out.n_ports, out.link_gbps)
    if max_packets is not None:
        out = out.head(int(max_packets))
    return out


def _stage_incast(tr: Trace, rng: np.random.Generator, *, dst: int = 0,
                  n_senders: int = 4, n_packets: int = 64,
                  payload_bytes: int = 1500, t_frac: float = 0.5,
                  window_s: Optional[float] = None) -> Trace:
    """Incast storm: ``n_senders`` distinct sources hammer one destination
    inside a short window — the classic fan-in buffer killer."""
    if len(tr) == 0:
        return tr
    others = np.asarray([p for p in range(tr.n_ports) if p != int(dst)],
                        np.int64)
    if others.size == 0:
        raise IngestError("incast: no source ports besides dst")
    senders = rng.choice(others, size=min(int(n_senders), others.size),
                         replace=False)
    window = float(window_s) if window_s is not None else max(
        tr.duration_s * 0.02, 1e-9)
    start = tr.time_s.min() + float(t_frac) * tr.duration_s
    times = start + rng.uniform(0.0, window, int(n_packets))
    src = senders[rng.integers(senders.size, size=int(n_packets))]
    return Trace(
        tr.name,
        np.concatenate([tr.time_s, times]),
        np.concatenate([tr.src, src.astype(np.int32)]),
        np.concatenate([tr.dst, np.full(int(n_packets), int(dst), np.int32)]),
        np.concatenate([tr.payload_bytes,
                        np.full(int(n_packets), int(payload_bytes), np.int64)]),
        tr.n_ports, tr.link_gbps)


def _stage_zipf_drift(tr: Trace, rng: np.random.Generator, *,
                      alpha: float = 1.2, frac: float = 0.5,
                      n_phases: int = 4) -> Trace:
    """Zipf popularity drift: a ``frac`` subset of packets is redirected to
    Zipf-popular destinations, and the popularity *ranking permutes* between
    ``n_phases`` time phases — hot destinations move mid-trace, defeating
    any single static hot-port assumption."""
    m = len(tr)
    if m == 0 or tr.n_ports < 2:
        return tr
    ranks = np.arange(1, tr.n_ports + 1, dtype=np.float64)
    probs = ranks ** -float(alpha)
    probs /= probs.sum()
    touched = rng.random(m) < float(frac)
    phase = np.zeros(m, np.int64)
    if tr.duration_s > 0:
        phase = np.minimum(
            ((tr.time_s - tr.time_s.min()) / tr.duration_s
             * int(n_phases)).astype(np.int64),
            int(n_phases) - 1)
    perms = np.stack([rng.permutation(tr.n_ports)
                      for _ in range(int(n_phases))])
    popular = rng.choice(tr.n_ports, size=m, p=probs)
    dst = tr.dst.copy()
    dst[touched] = perms[phase[touched], popular[touched]].astype(np.int32)
    return Trace(tr.name, tr.time_s, tr.src, dst, tr.payload_bytes,
                 tr.n_ports, tr.link_gbps)


def _stage_diurnal(tr: Trace, rng: np.random.Generator, *,
                   periods: float = 2.0, depth: float = 0.5) -> Trace:
    """Diurnal load: an order-preserving time warp that bunches arrivals at
    sinusoidal load peaks (``periods`` cycles over the trace, modulation
    depth in [0, 1)) — same packets, bursty-on-schedule arrival process."""
    if not 0 <= depth < 1:
        raise IngestError(f"diurnal depth must be in [0, 1), got {depth}")
    m = len(tr)
    if m == 0 or tr.duration_s == 0:
        return tr
    t0, dur = tr.time_s.min(), tr.duration_s
    u = (tr.time_s - t0) / dur                       # normalised [0, 1]
    w = 2.0 * math.pi * float(periods)
    # inverse-intensity warp of rate(u) = 1 + depth*sin(w u): cumulative
    # Λ(u) = u + depth/w (1 − cos(w u)), rescaled back onto the span
    lam = u + float(depth) / w * (1.0 - np.cos(w * u))
    lam_end = 1.0 + float(depth) / w * (1.0 - math.cos(w))
    t = t0 + lam / lam_end * dur
    return Trace(tr.name, t, tr.src, tr.dst, tr.payload_bytes,
                 tr.n_ports, tr.link_gbps)


#: stage registry: kind -> fn(trace, rng, **params).  filter/remap/rescale/
#: clip shape the capture; incast/zipf_drift/diurnal are generative stressors.
STAGES: Dict[str, Callable[..., Trace]] = {
    "filter": _stage_filter,
    "remap_ports": _stage_remap_ports,
    "rescale_time": _stage_rescale_time,
    "clip": _stage_clip,
    "incast": _stage_incast,
    "zipf_drift": _stage_zipf_drift,
    "diurnal": _stage_diurnal,
}


# --------------------------------------------------------------------------
# pipeline
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Stage:
    """One declarative transform: a registry kind plus its parameters."""

    kind: str
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in STAGES:
            raise IngestError(f"unknown stage {self.kind!r}; "
                              f"known: {sorted(STAGES)}")

    def apply(self, tr: Trace, rng: np.random.Generator) -> Trace:
        try:
            return STAGES[self.kind](tr, rng, **self.params)
        except TypeError as e:
            raise IngestError(f"stage {self.kind!r}: {e}") from e

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Stage":
        return cls(kind=d["kind"], params=dict(d.get("params", {})))


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """An ordered, serializable stage composition.

    Application order is tuple order — composition is order-deterministic by
    construction.  Stage i draws randomness from
    ``np.random.default_rng([seed, i])``: independent of every other stage's
    consumption, so inserting a deterministic stage never shifts a
    stressor's stream, and one ``seed`` reproduces the pipeline exactly."""

    stages: Tuple[Stage, ...] = ()
    seed: int = 0

    def then(self, kind: str, **params) -> "Pipeline":
        return dataclasses.replace(
            self, stages=self.stages + (Stage(kind, params),))

    def apply(self, tr: Trace) -> Trace:
        for i, stage in enumerate(self.stages):
            tr = stage.apply(tr, np.random.default_rng([int(self.seed), i]))
        return tr

    def to_dict(self) -> Dict[str, Any]:
        return {"seed": int(self.seed),
                "stages": [s.to_dict() for s in self.stages]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Pipeline":
        return cls(stages=tuple(Stage.from_dict(s)
                                for s in d.get("stages", [])),
                   seed=int(d.get("seed", 0)))


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def ingest(path, *, pipeline: Optional[Pipeline] = None,
           name: Optional[str] = None, n_ports: Optional[int] = None,
           link_gbps: float = 100.0) -> Trace:
    """Capture file → simulation-ready ``Trace``.

    Dispatches on content (pcap magic) falling back to suffix, applies the
    pipeline, and validates the result is non-empty and addressable."""
    p = Path(path)
    try:
        head = p.open("rb").read(4)
    except OSError as e:
        raise IngestError(f"cannot read {p}: {e}") from e
    is_pcap = (len(head) == 4
               and (struct.unpack("<I", head)[0] in _PCAP_MAGICS
                    or struct.unpack(">I", head)[0] in _PCAP_MAGICS))
    if is_pcap or p.suffix.lower() in (".pcap", ".cap"):
        tr = read_pcap(p, name=name, n_ports=n_ports, link_gbps=link_gbps)
    elif p.suffix.lower() in (".csv", ".txt", ""):
        tr = read_csv(p, name=name, n_ports=n_ports, link_gbps=link_gbps)
    else:
        raise IngestError(f"{p}: unrecognised capture format "
                          f"(need .pcap/.cap or .csv)")
    if pipeline is not None:
        tr = pipeline.apply(tr)
    if len(tr) == 0:
        raise IngestError(f"{p}: pipeline produced an empty trace")
    return tr
