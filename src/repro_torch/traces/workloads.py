"""The five evaluation workloads (§V-A), as parameterised generators.

Each generator matches the published packet statistics:

* **HFT** — low latency, high burstiness (market-data bursts), 24 B payloads
  (Table II), feed fan-out concentrated on a few subscriber ports.
* **RL All-Reduce** — iSwitch-style synchronous rounds: workers → aggregator
  incast with ~1463 B gradient chunks, then broadcast back; regular + hotspot.
* **DataCenter** — Alibaba-trace-style microservice RPC: heavy-tailed mice
  flows (~965 B mean), Zipf destination popularity over 32 nodes.
* **Industry** — SCADA polling from the medical-waste-incinerator capture:
  master/outstation request/response, ~58.7 B payloads, low rate, regular.
* **Underwater** — 8 DESERT robots, periodic 2 B beacons.
"""

from __future__ import annotations

import numpy as np

from .base import Trace, burst_times, poisson_times

__all__ = ["hft", "rl_allreduce", "datacenter", "industry", "underwater", "uniform", "WORKLOADS"]


def hft(
    seed: int = 0,
    n_ports: int = 8,
    duration_s: float = 400e-6,
    link_gbps: float = 10.0,
    load: float = 0.35,
) -> Trace:
    rng = np.random.default_rng(seed)
    # feed handlers on ports 0-1 publish to subscriber ports; bursts on ticks
    payload = 24
    pkt_s = (payload + 42) * 8 / (link_gbps * 1e9)
    per_src_rate = load * link_gbps * 1e9 / ((payload + 42) * 8) / n_ports
    times, srcs, dsts = [], [], []
    for s in range(n_ports):
        bursty = s < 2  # feed sources burst hard
        t = burst_times(
            rng,
            burst_rate_ps=per_src_rate / (8.0 if bursty else 2.0),
            duration_s=duration_s,
            burst_len_mean=8.0 if bursty else 2.0,
            intra_gap_s=pkt_s * 1.05,
        )
        times.append(t)
        srcs.append(np.full(t.size, s))
        # subscribers cluster: Zipf-ish preference for ports 2-4
        pref = np.array([0.05, 0.05, 0.3, 0.25, 0.15, 0.08, 0.07, 0.05][:n_ports])
        pref[s] = 0.0
        pref = pref / pref.sum()
        dsts.append(rng.choice(n_ports, size=t.size, p=pref))
    n = sum(t.size for t in times)
    return Trace("hft", np.concatenate(times), np.concatenate(srcs),
                 np.concatenate(dsts), np.full(n, payload), n_ports, link_gbps)


def rl_allreduce(
    seed: int = 0,
    n_ports: int = 8,
    rounds: int = 12,
    chunks_per_round: int = 24,
    payload: int = 1463,
    link_gbps: float = 10.0,
) -> Trace:
    """iSwitch [46]: workers stream gradient chunks to the aggregator (port 0),
    which broadcasts the reduced tensor back — incast then fan-out, per round."""
    rng = np.random.default_rng(seed)
    pkt_s = (payload + 42) * 8 / (link_gbps * 1e9)
    n_w = n_ports - 1
    # a round = synchronised incast (workers at line rate, in parallel) then the
    # aggregator's fan-out, which its single link must serialise
    bcast_s = chunks_per_round * n_w * pkt_s * 1.02
    round_gap = chunks_per_round * pkt_s * 1.3 + bcast_s * 1.15
    times, srcs, dsts = [], [], []
    for r in range(rounds):
        base = r * round_gap
        for w in range(1, n_ports):  # incast: all workers → port 0, synchronised
            jit = rng.uniform(0, pkt_s * 0.5)
            t = base + jit + np.arange(chunks_per_round) * pkt_s * 1.02
            times.append(t)
            srcs.append(np.full(t.size, w))
            dsts.append(np.zeros(t.size, dtype=np.int64))
        # fan-out of the reduced tensor: one serialised stream from port 0
        bb = base + chunks_per_round * pkt_s * 1.2
        seq = np.arange(chunks_per_round * n_w)
        t = bb + seq * pkt_s * 1.02
        times.append(t)
        srcs.append(np.zeros(t.size, dtype=np.int64))
        dsts.append(1 + (seq % n_w))
    n = sum(t.size for t in times)
    return Trace("rl_allreduce", np.concatenate(times), np.concatenate(srcs),
                 np.concatenate(dsts), np.full(n, payload), n_ports, link_gbps)


def datacenter(
    seed: int = 0,
    n_ports: int = 32,
    duration_s: float = 800e-6,
    link_gbps: float = 25.0,
    load: float = 0.2,
    mean_payload: float = 965.5,
) -> Trace:
    rng = np.random.default_rng(seed)
    mean_wire = mean_payload + 42
    rate = load * link_gbps * 1e9 / (mean_wire * 8) / n_ports
    times, srcs, dsts, sizes = [], [], [], []
    # Zipf destination popularity (microservice hotspots)
    ranks = np.arange(1, n_ports + 1, dtype=np.float64)
    zipf = (1.0 / ranks**1.1)
    for s in range(n_ports):
        t = poisson_times(rng, rate, duration_s)
        times.append(t)
        srcs.append(np.full(t.size, s))
        p = zipf.copy()
        p[s] = 0.0
        p /= p.sum()
        dsts.append(rng.choice(n_ports, size=t.size, p=p))
        # heavy-tailed mice: lognormal with the published mean
        raw = rng.lognormal(mean=np.log(200), sigma=1.3, size=t.size)
        sizes.append(np.clip(raw * (mean_payload / max(raw.mean(), 1.0)), 4, 9000).astype(np.int64))
    n = sum(t.size for t in times)
    return Trace("datacenter", np.concatenate(times), np.concatenate(srcs),
                 np.concatenate(dsts), np.concatenate(sizes), n_ports, link_gbps)


def industry(
    seed: int = 0,
    n_ports: int = 10,
    duration_s: float = 2e-3,
    link_gbps: float = 10.0,
    poll_period_s: float = 40e-6,
) -> Trace:
    """SCADA master (port 0) polls outstations round-robin; responses return."""
    rng = np.random.default_rng(seed)
    times, srcs, dsts, sizes = [], [], [], []
    t = 0.0
    station = 1
    while t < duration_s:
        # request master->station (small), response station->master (58.7B mean)
        times += [t, t + 6e-6 + rng.uniform(0, 2e-6)]
        srcs += [0, station]
        dsts += [station, 0]
        sizes += [16, max(2, int(rng.normal(58.7, 10)))]
        station = station % (n_ports - 1) + 1
        t += poll_period_s / (n_ports - 1)
    n = len(times)
    return Trace("industry", np.array(times), np.array(srcs), np.array(dsts),
                 np.array(sizes, dtype=np.int64), n_ports, link_gbps)


def underwater(
    seed: int = 0,
    n_ports: int = 8,
    duration_s: float = 4e-3,
    link_gbps: float = 1.0,
    beacon_period_s: float = 50e-6,
) -> Trace:
    """8 DESERT robots exchange 2 B beacons on a regular schedule."""
    rng = np.random.default_rng(seed)
    times, srcs, dsts = [], [], []
    for s in range(n_ports):
        t = np.arange(s * beacon_period_s / n_ports, duration_s, beacon_period_s)
        t = t + rng.uniform(0, beacon_period_s * 0.02, size=t.size)
        times.append(t)
        srcs.append(np.full(t.size, s))
        dsts.append(rng.permutation(np.resize(np.delete(np.arange(n_ports), s), t.size)))
    n = sum(t.size for t in times)
    return Trace("underwater", np.concatenate(times), np.concatenate(srcs),
                 np.concatenate(dsts), np.full(n, 2), n_ports, link_gbps)


def uniform(
    seed: int = 0,
    n_ports: int = 8,
    duration_s: float = 400e-6,
    link_gbps: float = 10.0,
    load: float = 0.6,
    payload: int = 512,
) -> Trace:
    """Uniform Bernoulli traffic — the Fig. 1/Fig. 8 sensitivity baseline."""
    rng = np.random.default_rng(seed)
    rate = load * link_gbps * 1e9 / ((payload + 42) * 8) / n_ports
    times, srcs, dsts = [], [], []
    for s in range(n_ports):
        t = poisson_times(rng, rate, duration_s)
        times.append(t)
        srcs.append(np.full(t.size, s))
        d = rng.integers(0, n_ports - 1, size=t.size)
        dsts.append(np.where(d >= s, d + 1, d))
    n = sum(t.size for t in times)
    return Trace("uniform", np.concatenate(times), np.concatenate(srcs),
                 np.concatenate(dsts), np.full(n, payload), n_ports, link_gbps)


WORKLOADS = {
    "hft": hft,
    "rl_allreduce": rl_allreduce,
    "datacenter": datacenter,
    "industry": industry,
    "underwater": underwater,
    "uniform": uniform,
}
