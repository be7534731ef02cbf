"""Trace substrate: the packet-trace datatype shared by simulators and DSE."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Trace", "merge", "poisson_times", "burst_times"]


@dataclasses.dataclass
class Trace:
    """A packet trace: parallel arrays sorted by time."""

    name: str
    time_s: np.ndarray        # float64 [n]
    src: np.ndarray           # int32 [n] source port/host
    dst: np.ndarray           # int32 [n] destination port/host
    payload_bytes: np.ndarray # int64 [n]
    n_ports: int
    link_gbps: float = 100.0

    def __post_init__(self):
        order = np.argsort(self.time_s, kind="stable")
        self.time_s = np.asarray(self.time_s, np.float64)[order]
        self.src = np.asarray(self.src, np.int32)[order]
        self.dst = np.asarray(self.dst, np.int32)[order]
        self.payload_bytes = np.asarray(self.payload_bytes, np.int64)[order]

    def __len__(self) -> int:
        return int(self.time_s.size)

    @property
    def duration_s(self) -> float:
        return float(self.time_s.max() - self.time_s.min()) if len(self) > 1 else 0.0

    def offered_gbps(self, header_bytes: int = 0) -> float:
        bits = float((self.payload_bytes + header_bytes).sum() * 8)
        return bits / max(self.duration_s, 1e-12) / 1e9

    def head(self, n: int) -> "Trace":
        return Trace(self.name, self.time_s[:n], self.src[:n], self.dst[:n],
                     self.payload_bytes[:n], self.n_ports, self.link_gbps)

    # ------------------------------------------------------------ persistence
    def save(self, path) -> None:
        """Write the trace as a ``.npz`` archive (lossless, pickle-free).

        Saved traces are what ``repro.api.TraceSpec(path=...)`` references, so
        a captured trace is a first-class scenario input alongside the named
        generators."""
        np.savez_compressed(
            path,
            time_s=self.time_s, src=self.src, dst=self.dst,
            payload_bytes=self.payload_bytes,
            meta_name=np.asarray(self.name),
            meta_n_ports=np.asarray(self.n_ports, np.int64),
            meta_link_gbps=np.asarray(self.link_gbps, np.float64),
        )

    @classmethod
    def load(cls, path) -> "Trace":
        """Inverse of :meth:`save`; round-trips every field exactly."""
        with np.load(path, allow_pickle=False) as z:
            return cls(
                name=str(z["meta_name"][()]),
                time_s=z["time_s"], src=z["src"], dst=z["dst"],
                payload_bytes=z["payload_bytes"],
                n_ports=int(z["meta_n_ports"][()]),
                link_gbps=float(z["meta_link_gbps"][()]),
            )


def merge(name: str, traces, n_ports: int, link_gbps: float = 100.0) -> Trace:
    """Combine per-port-domain sub-traces into one trace.

    The inputs must be one consistent capture: every sub-trace on the same
    link rate (service times and hop composition are priced against a single
    ``link_gbps``) and on *disjoint* port ids (two sub-traces claiming the
    same endpoint would silently interleave two hosts' traffic into one) —
    both are validated here because multi-hop fabric composition depends on
    them.
    """
    traces = list(traces)
    if not traces:
        raise ValueError("merge() needs at least one trace")
    for t in traces:
        if t.link_gbps != link_gbps:
            raise ValueError(
                f"merge link_gbps mismatch: merged trace declares "
                f"{link_gbps} Gbps but input {t.name!r} carries "
                f"{t.link_gbps} Gbps — resample one side first")
    owner: dict = {}
    for t in traces:
        ports = np.union1d(np.unique(t.src), np.unique(t.dst))
        for p in ports:
            p = int(p)
            if p in owner and owner[p] != t.name:
                raise ValueError(
                    f"merge port overlap: port id {p} appears in both "
                    f"{owner[p]!r} and {t.name!r} — merged sub-traces must "
                    f"cover disjoint port ids")
            owner[p] = t.name
        if ports.size and int(ports.max()) >= n_ports:
            raise ValueError(
                f"merge port out of range: input {t.name!r} uses port id "
                f"{int(ports.max())} but the merged trace declares "
                f"n_ports={n_ports}")
    return Trace(
        name=name,
        time_s=np.concatenate([t.time_s for t in traces]),
        src=np.concatenate([t.src for t in traces]),
        dst=np.concatenate([t.dst for t in traces]),
        payload_bytes=np.concatenate([t.payload_bytes for t in traces]),
        n_ports=n_ports,
        link_gbps=link_gbps,
    )


def poisson_times(rng: np.random.Generator, rate_pps: float, duration_s: float) -> np.ndarray:
    n = rng.poisson(rate_pps * duration_s)
    return np.sort(rng.uniform(0.0, duration_s, size=n))


def burst_times(
    rng: np.random.Generator,
    burst_rate_ps: float,
    duration_s: float,
    burst_len_mean: float,
    intra_gap_s: float,
) -> np.ndarray:
    """Poisson bursts of geometric length with fixed intra-burst spacing."""
    starts = poisson_times(rng, burst_rate_ps, duration_s)
    out = []
    for s in starts:
        blen = 1 + rng.geometric(1.0 / max(burst_len_mean, 1.0))
        out.append(s + np.arange(blen) * intra_gap_s)
    if not out:
        return np.zeros(0)
    return np.sort(np.concatenate(out))
