"""The composed SPAC switch: parser ∘ kernels ∘ table ∘ VOQ ∘ scheduler ∘ deparser.

A cycle-level, vectorised PyTorch model of the generated switch.  One step
of the loop in ``simulate`` = one clock cycle of the FPGA datapath:

  1. ingress: per-port arriving flit (head flit carries the packed header);
     the compile-time-specialised parser extracts routing/src keys,
  2. the forward table learns src→port and looks up the output port
     (miss ⇒ broadcast),
  3. custom kernels (optional, §III-B.5) may rewrite destinations/drop,
  4. the VOQ buffer enqueues (drops when full),
  5. the scheduler computes an input/output matching,
  6. matched heads dequeue; multi-flit packets hold their input & output busy
     for ``size_flits`` cycles (serialisation),

This model is the repo's "real hardware": hardware back-annotation
(``repro_torch.sim.backannotate``) measures the scheduler efficiency on it,
and ``verify_engine="cycle"``/``"auto"`` verify on it (rung 4).

PyTorch port of the JAX package's ``switch/switch.py``.  The reference's
jitted ``lax.scan`` over cycles becomes the ``switch_loop`` op
(``repro_torch.kernels.switch_loop``): on a card, one launch of a
hand-written CUDA kernel runs every cycle of the simulation; on the CPU its
plain version, the eager loop, steps the table, VOQ and scheduler modules
here once a cycle.  An architecture whose custom kernel carries a Python
``fn`` runs on a card as two launches of that kernel: every cycle's
ingress (steps 1-2), then the hooks stepped once a cycle on the host, then
every cycle's egress (steps 4-6) — exact, since nothing of egress flows
back into ingress; on the CPU the eager loop calls the hook inside each
cycle.  The ``fn`` contract is ``CustomKernelSpec``'s
(``core/archspec.py``).  The loop takes the packed header words
and the routing and src keys' baked slices: on a card the kernel parses
each arriving header at ingress, as the reference's cycle step does (and
the FPGA's parser); the eager loop extracts every header's keys once
before it.  Latency, percentiles and throughput are host
NumPy after the loop, copied from the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.archspec import SwitchArch
from repro_torch.core.binding import BoundProtocol
from repro_torch.device import resolve_device
from repro_torch.kernels.parser import slices
from repro_torch.kernels.switch_loop import ops as loop_ops
from .parser import pack_header_words

__all__ = ["SwitchSimResult", "prepare_cycle_inputs", "sim_result", "simulate"]


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
    the cycles run: on a card, one launch of the ``switch_loop`` kernel for
    the whole simulation; on the CPU, its plain version, the eager loop.
    An architecture with a custom kernel whose ``fn`` is a Python callable
    runs on a card as the kernel's ingress pass, the hooks stepped once a
    cycle on the host (CPU tensors), and its egress pass; the result is the
    eager loop's bit for bit."""
    dev = resolve_device(device)
    prep = prepare_cycle_inputs(arch, bound, trace, fclk_hz, max_cycles=max_cycles)
    size_flits = torch.from_numpy(prep["size_flits"]).to(dev)
    words = torch.from_numpy(prep["header_words"]).to(dev)
    keys = slices(bound.protocol, [bound.semantics["routing_key"],
                                   bound.semantics["src_key"]]).baked
    arr = torch.from_numpy(prep["arr_pid"]).to(dev)
    out = loop_ops.switch_loop(arch, arr, words, size_flits, keys)
    return sim_result(arch, prep, out, fclk_hz)


def sim_result(arch: SwitchArch, prep: Dict[str, np.ndarray], out,
               fclk_hz: float) -> SwitchSimResult:
    """The per-packet stats of one loop's outputs (``SwitchLoopOut``) on the
    trace ``prep`` binned."""
    dep = out.dep_cycle.cpu().numpy()
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
        drops=int(out.drops),
        offered=int(prep["header_words"].shape[0]),
        delivered_copies=int(out.delivered),
        throughput_gbps=delivered_bits / sim_s / 1e9,
        goodput_gbps=goodput_bits / sim_s / 1e9,
        occ_max=out.occ_max.cpu().numpy(),
        occ_trace=out.occ_trace.cpu().numpy(),
        data_slots_max=int(out.data_slots_max),
        n_cycles=int(prep["n_cycles"]),
        fclk_hz=fclk_hz,
    )
