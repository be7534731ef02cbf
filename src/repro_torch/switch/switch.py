"""The composed SPAC switch: parser ∘ kernels ∘ table ∘ VOQ ∘ scheduler ∘ deparser.

A cycle-level, vectorised PyTorch model of the generated switch.  One step
of the loop in ``simulate`` = one clock cycle of the FPGA datapath:

  1. ingress: per-port arriving flit (head flit carries the packed header);
     the compile-time-specialised parser extracts routing/src keys,
  2. custom kernels (optional, §III-B.5) may rewrite destinations/drop,
  3. the forward table learns src→port and looks up the output port
     (miss ⇒ broadcast),
  4. the VOQ buffer enqueues (drops when full),
  5. the scheduler computes an input/output matching,
  6. matched heads dequeue; multi-flit packets hold their input & output busy
     for ``size_flits`` cycles (serialisation),

This model is the repo's "real hardware": hardware back-annotation
(``repro_torch.sim.backannotate``) measures the scheduler efficiency on it,
and ``verify_engine="cycle"``/``"auto"`` verify on it (rung 4).

PyTorch port of the JAX package's ``switch/switch.py``.  The reference's
jitted ``lax.scan`` becomes a Python loop over cycles whose body runs on the
device and never reads a device value on the host, so the card runs ahead
of the loop; counters stay tensors until the loop ends.  Every header is
parsed once, before the loop, by the parser op (the hand-written CUDA
kernel on a card) and each cycle gathers its ports' fields: parsing is a
pure function of the packet, so this is the reference's per-cycle parse.
Latency, percentiles and throughput are host NumPy after the loop, copied
from the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.archspec import SchedulerKind, SwitchArch
from repro_torch.core.binding import BoundProtocol
from repro_torch.device import resolve_device
from repro_torch.kernels.parser import parse_headers
from . import forward_table as ft
from . import scheduler as sch
from . import voq as vq
from .parser import pack_header_words

__all__ = ["SwitchSimResult", "prepare_cycle_inputs", "simulate"]


@dataclasses.dataclass
class SwitchSimResult:
    latency_cycles: np.ndarray      # per delivered packet (last copy), queueing incl.
    latency_ns: np.ndarray          # + pipeline latency, at fclk
    drops: int
    offered: int
    delivered_copies: int
    throughput_gbps: float          # delivered payload+header bits / sim time
    goodput_gbps: float             # delivered payload bits / sim time
    occ_max: np.ndarray             # [N, N] per-queue max occupancy
    occ_trace: np.ndarray           # [T] per-cycle max queue occupancy
    data_slots_max: int
    n_cycles: int
    fclk_hz: float

    @property
    def drop_rate(self) -> float:
        return self.drops / max(self.offered, 1)

    def p(self, q: float) -> float:
        return float(np.percentile(self.latency_ns, q)) if self.latency_ns.size else math.inf


def prepare_cycle_inputs(
    arch: SwitchArch,
    bound: BoundProtocol,
    trace,
    fclk_hz: float,
    *,
    drain_cycles: int = 2048,
    max_cycles: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Bin a trace into per-cycle per-port arrivals with link serialisation."""
    n = arch.n_ports
    t = np.asarray(trace.time_s, dtype=np.float64)
    src = np.asarray(trace.src, dtype=np.int64) % n
    dst = np.asarray(trace.dst, dtype=np.int64) % n
    payload = np.asarray(trace.payload_bytes, dtype=np.int64)
    order = np.argsort(t, kind="stable")
    t, src, dst, payload = t[order], src[order], dst[order], payload[order]
    npkt = t.size

    wire_bytes = payload + bound.header_bytes
    flit_bytes = arch.bus_bits // 8
    size_flits = np.maximum(1, -(-wire_bytes // flit_bytes)).astype(np.int32)

    # ingress serialisation: each port delivers one flit/cycle
    arr_cycle = np.zeros(npkt, dtype=np.int64)
    port_free = np.zeros(n, dtype=np.int64)
    rel = t - t.min()
    for k in range(npkt):
        c = int(round(rel[k] * fclk_hz))
        c = max(c, port_free[src[k]])
        arr_cycle[k] = c
        port_free[src[k]] = c + size_flits[k]

    total_cycles = int(arr_cycle.max() + size_flits.max() + drain_cycles) if npkt else drain_cycles
    if max_cycles is not None and total_cycles > max_cycles:
        total_cycles = max_cycles
    keep = arr_cycle < total_cycles
    arr_pid = np.full((total_cycles, n), -1, dtype=np.int32)
    arr_pid[arr_cycle[keep], src[keep]] = np.nonzero(keep)[0].astype(np.int32)

    # pack headers once (the host driver / NetBlocks role)
    vals = {
        bound.semantics["routing_key"]: dst.astype(np.uint64),
        bound.semantics["src_key"]: src.astype(np.uint64),
    }
    if bound.has("length"):
        f = bound.protocol.field(bound.semantics["length"])
        vals[bound.semantics["length"]] = np.minimum(payload, (1 << f.bits) - 1).astype(np.uint64)
    words = pack_header_words(bound.protocol, vals)

    return dict(
        arr_pid=arr_pid,
        header_words=words.astype(np.uint32),
        size_flits=size_flits,
        payload_bytes=payload.astype(np.int64),
        wire_bytes=wire_bytes.astype(np.int64),
        arr_cycle=arr_cycle,
        n_cycles=np.int64(total_cycles),
    )


class _Carry(NamedTuple):
    table: object
    voq: vq.VOQState
    sched: sch.SchedState
    busy_in: torch.Tensor     # [N] cycles remaining
    busy_out: torch.Tensor
    dep_cycle: torch.Tensor   # [n_packets] last-copy departure cycle (-1 = not yet)
    delivered: torch.Tensor   # scalar copies delivered
    occ_max: torch.Tensor     # [N, N]
    data_max: torch.Tensor    # scalar
    kstates: Tuple            # custom kernel states


def simulate(
    arch: SwitchArch,
    bound: BoundProtocol,
    trace,
    *,
    fclk_hz: float,
    max_cycles: Optional[int] = None,
    device=None,
) -> SwitchSimResult:
    """Run the cycle-level switch on a trace and gather per-packet stats.

    ``device`` (default: the first CUDA device; raises without one) is where
    the cycle loop runs."""
    dev = resolve_device(device)
    prep = prepare_cycle_inputs(arch, bound, trace, fclk_hz, max_cycles=max_cycles)
    n = arch.n_ports
    npkt = prep["header_words"].shape[0]
    size_flits = torch.from_numpy(prep["size_flits"]).to(dev, torch.int64)
    # parse every header once: [npkt, 2] (routing key, src key)
    words = torch.from_numpy(prep["header_words"]).to(dev)
    keys = parse_headers(bound.protocol, [bound.semantics["routing_key"],
                                          bound.semantics["src_key"]], words)
    keys = keys.to(torch.int64)
    kernels = list(arch.custom_kernels)
    in_ports = torch.arange(n, dtype=torch.int64, device=dev)
    is_edrrm = arch.sched is SchedulerKind.EDRRM

    def cycle_step(c: _Carry, cyc: torch.Tensor, pids: torch.Tensor):
        valid = pids >= 0
        fields = keys[torch.clamp(pids, min=0)]               # [N, 2]
        dst_key, src_key = fields[:, 0], fields[:, 1]
        # learn then lookup (learning on every arrival, §III-B.2)
        table = ft.learn(arch, c.table, src_key, in_ports, valid)
        out_port = ft.lookup(arch, table, dst_key, valid)
        # custom kernel hooks
        kstates = []
        for spec, kst in zip(kernels, c.kstates):
            if spec.fn is not None:
                kst, out_port, valid = spec.fn(kst, pids, out_port, valid, cyc)
            kstates.append(kst)
        voq = vq.enqueue(arch, c.voq, pids, out_port, valid)
        occ = vq.occupancy(voq)
        match, sched = sch.schedule(arch, c.sched, occ, c.busy_in > 0, c.busy_out > 0)
        voq, dep_pid, dep_in = vq.dequeue(arch, voq, match)
        if is_edrrm:
            # the other schedulers never hold (held stays -1): a no-op there
            sched = sch.release_exhausted(sched, match, vq.occupancy(voq))
        # busy counters: transfer occupies ports for size_flits cycles total
        dep_valid = dep_pid >= 0
        dep_safe = torch.clamp(dep_pid, min=0)
        dep_sz = size_flits[dep_safe]
        hold = dep_sz - 1
        busy_out = torch.where(dep_valid, hold, torch.clamp(c.busy_out - 1, min=0))
        in_sz = torch.zeros_like(c.busy_in).scatter_reduce_(
            0, torch.clamp(dep_in, min=0), torch.where(dep_valid, hold, 0), "amax")
        busy_in = torch.maximum(torch.clamp(c.busy_in - 1, min=0), in_sz)
        # departure bookkeeping (last flit leaves at cyc + size); dep_cycle
        # belongs to this loop, so it is updated in place
        c.dep_cycle.scatter_reduce_(0, dep_safe, torch.where(dep_valid, cyc + dep_sz, -1),
                                    "amax")
        delivered = c.delivered + dep_valid.sum()
        occ_max = torch.maximum(c.occ_max, occ)
        data_max = torch.maximum(c.data_max, voq.data_slots)
        carry = _Carry(table, voq, sched, busy_in, busy_out, c.dep_cycle,
                       delivered, occ_max, data_max, tuple(kstates))
        return carry, occ.amax()

    z = lambda *s: torch.zeros(s, dtype=torch.int64, device=dev)  # noqa: E731
    c = _Carry(
        table=ft.init_table(arch, dev),
        voq=vq.init_voq(arch, npkt, dev),
        sched=sch.init_sched(arch, dev),
        busy_in=z(n),
        busy_out=z(n),
        dep_cycle=torch.full((max(npkt, 1),), -1, dtype=torch.int64, device=dev),
        delivered=z(),
        occ_max=z(n, n),
        data_max=z(),
        kstates=tuple(getattr(k, "init_state", None) for k in kernels),
    )
    n_cycles = int(prep["n_cycles"])
    arr = torch.from_numpy(prep["arr_pid"]).to(dev, torch.int64)
    cycles = torch.arange(n_cycles, dtype=torch.int64, device=dev)
    occ_trace = torch.empty((n_cycles,), dtype=torch.int64, device=dev)
    for k in range(n_cycles):
        c, occ_peak = cycle_step(c, cycles[k], arr[k])
        occ_trace[k] = occ_peak

    dep = c.dep_cycle.cpu().numpy()
    arrc = prep["arr_cycle"]
    done = dep >= 0
    lat_cycles = (dep[done] - arrc[done]).astype(np.float64)
    lat_ns = (lat_cycles + arch.pipeline_depth) / fclk_hz * 1e9
    sim_s = float(prep["n_cycles"]) / fclk_hz
    delivered_bits = float(prep["wire_bytes"][done].sum() * 8)
    goodput_bits = float(prep["payload_bytes"][done].sum() * 8)
    return SwitchSimResult(
        latency_cycles=lat_cycles,
        latency_ns=lat_ns,
        drops=int(c.voq.drops),
        offered=int(npkt),
        delivered_copies=int(c.delivered),
        throughput_gbps=delivered_bits / sim_s / 1e9,
        goodput_gbps=goodput_bits / sim_s / 1e9,
        occ_max=c.occ_max.cpu().numpy(),
        occ_trace=occ_trace.cpu().numpy(),
        data_slots_max=int(c.data_max),
        n_cycles=int(prep["n_cycles"]),
        fclk_hz=fclk_hz,
    )
