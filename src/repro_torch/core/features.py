"""Trace feature extraction (§IV-B): f = [I_burst, H_addr, S_min].

* ``I_burst`` — Index of Dispersion for Counts (IDC) over fixed windows; a
  congestion / burstiness proxy (Poisson arrivals → IDC ≈ 1, bursty ≫ 1).
* ``H_addr`` — Shannon entropy of destination addresses (bits), normalised
  variant also provided; indicates forwarding-cache effectiveness and
  incast-ness.
* ``S_min`` — minimum payload observed in the windowed trace; defines the
  worst-case arrival rate and the strict timing budget for the pipeline.

The same extractor is reused by the TPU comm layer, where "packets" are MoE
token dispatches (dst = expert id) or gradient buckets (dst = reduction peer):
expert-load dispersion ≡ IDC, routing entropy ≡ H_addr, token payload ≡ S_min.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["TraceFeatures", "analyze", "idc", "address_entropy"]


@dataclasses.dataclass(frozen=True)
class TraceFeatures:
    i_burst: float          # IDC (index of dispersion for counts)
    h_addr: float           # dest-address entropy, bits
    h_addr_norm: float      # entropy / log2(n_dsts), in [0, 1]
    s_min: int              # min payload bytes
    s_mean: float           # mean payload bytes
    rate_pps: float         # mean packet rate (packets/s)
    peak_rate_pps: float    # max windowed packet rate
    incast_ratio: float     # max share of traffic landing on one destination
    n_packets: int
    duration_s: float

    def describe(self) -> str:
        return (
            f"I_burst={self.i_burst:.2f} H_addr={self.h_addr:.2f}b "
            f"(norm {self.h_addr_norm:.2f}) S_min={self.s_min}B "
            f"S_mean={self.s_mean:.1f}B rate={self.rate_pps:.3g}pps "
            f"peak={self.peak_rate_pps:.3g}pps incast={self.incast_ratio:.2f}"
        )


def idc(times_s: np.ndarray, window_s: Optional[float] = None) -> float:
    """Index of Dispersion for Counts: Var(N_w)/E(N_w) over fixed windows."""
    times_s = np.asarray(times_s, dtype=np.float64)
    if times_s.size < 2:
        return 1.0
    span = float(times_s.max() - times_s.min())
    if span <= 0:
        return 1.0
    if window_s is None:
        # aim for ~200 windows with >=1 expected packet each
        window_s = max(span / 200.0, span / max(times_s.size, 1) * 4)
    edges = np.arange(times_s.min(), times_s.max() + window_s, window_s)
    counts, _ = np.histogram(times_s, bins=edges)
    m = counts.mean()
    if m <= 0:
        return 1.0
    return float(counts.var() / m)


def address_entropy(dsts: np.ndarray, n_dsts: Optional[int] = None) -> float:
    dsts = np.asarray(dsts)
    if dsts.size == 0:
        return 0.0
    _, counts = np.unique(dsts, return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log2(p)).sum())


def analyze(trace: "repro.traces.base.Trace", window_s: Optional[float] = None) -> TraceFeatures:  # noqa: F821
    """Characterise a trace into the Algorithm-1 feature vector f."""
    t = np.asarray(trace.time_s, dtype=np.float64)
    sizes = np.asarray(trace.payload_bytes)
    dsts = np.asarray(trace.dst)
    n = int(t.size)
    span = float(t.max() - t.min()) if n > 1 else 1e-9
    h = address_entropy(dsts)
    n_dsts = max(int(trace.n_ports), 2)
    # windowed peak rate
    if n > 1:
        w = window_s or max(span / 200.0, 1e-9)
        edges = np.arange(t.min(), t.max() + w, w)
        counts, _ = np.histogram(t, bins=edges)
        peak = float(counts.max() / w)
    else:
        peak = n / max(span, 1e-9)
    _, dst_counts = np.unique(dsts, return_counts=True)
    return TraceFeatures(
        i_burst=idc(t, window_s),
        h_addr=h,
        h_addr_norm=h / np.log2(n_dsts),
        s_min=int(sizes.min()) if n else 0,
        s_mean=float(sizes.mean()) if n else 0.0,
        rate_pps=n / max(span, 1e-9),
        peak_rate_pps=peak,
        incast_ratio=float(dst_counts.max() / max(dst_counts.sum(), 1)) if n else 0.0,
        n_packets=n,
        duration_s=span,
    )
