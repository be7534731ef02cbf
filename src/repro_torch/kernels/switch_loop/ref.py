"""The cycle-level switch's loop over cycles, plain PyTorch version.

The counterpart of the JAX package's jitted ``lax.scan`` in
``switch/switch.py`` (``simulate``'s ``cycle_step``): a Python loop over
cycles whose body steps the forward table (``switch/forward_table.py``),
the VOQs (``switch/voq.py``) and the scheduler (``switch/scheduler.py``) on
tensors, on the device of its inputs, without reading a device value on
the host.  The headers' routing and src keys are extracted once, before
the loop, by ``kernels/parser/ref.extract_fields``: parsing is a pure
function of the packet, so this is the reference's per-cycle parse.  Exact integer arithmetic, so the CUDA kernel (``kernel.py``) is
held to it bit for bit.

One cycle is an ingress step (``ingress_step``: the parse's keys, the
forward table's learn and lookup) followed by the custom kernels' hooks and
an egress step (``egress_step``: the VOQ enqueue, the schedule, the dequeue,
the busy counters and the bookkeeping).  Nothing of egress flows back into
ingress, so ``ingress_ref`` can run every cycle's ingress first, the hooks
can then be stepped once a cycle (``hooks.run_hooks``), and ``egress_ref``
every cycle's egress after them, with the same result bit for bit as
``switch_loop_ref``, which composes the three a cycle at a time.

``simulate`` on the CPU runs ``switch_loop_ref``, hooks included.  On the
card the fused kernel is held to it; for an architecture whose custom kernel
carries a Python ``fn``, the kernel's ingress and egress passes are held to
``ingress_ref`` and ``egress_ref`` (``chip_smoke.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.archspec import SchedulerKind, SwitchArch
from repro_torch.kernels.parser.ref import Baked, extract_fields
from repro_torch.switch import forward_table as ft
from repro_torch.switch import scheduler as sch
from repro_torch.switch import voq as vq

from . import hooks

__all__ = ["SwitchLoopOut", "egress_ref", "egress_step", "ingress_ref", "ingress_step",
           "switch_loop_ref"]


class SwitchLoopOut(NamedTuple):
    dep_cycle: torch.Tensor       # [max(npkt, 1)] int64 last copy's departure cycle, -1 never
    occ_trace: torch.Tensor       # [T] int64 per-cycle max queue occupancy
    occ_max: torch.Tensor         # [N, N] int64 per-queue max occupancy
    delivered: torch.Tensor       # int64 scalar, copies delivered
    drops: torch.Tensor           # int64 scalar, copies dropped
    data_slots_max: torch.Tensor  # int64 scalar


class _Egress(NamedTuple):
    voq: vq.VOQState
    sched: sch.SchedState
    busy_in: torch.Tensor     # [N] cycles remaining
    busy_out: torch.Tensor
    dep_cycle: torch.Tensor   # [n_packets] last-copy departure cycle (-1 = not yet)
    delivered: torch.Tensor   # scalar copies delivered
    occ_max: torch.Tensor     # [N, N]
    data_max: torch.Tensor    # scalar


def _keys(key_slices: Baked, words: torch.Tensor, dev) -> torch.Tensor:
    """Every packet's routing (column 0) and src (column 1) key."""
    return torch.stack(extract_fields(key_slices, words.to(dev)), dim=1)   # [npkt, 2]


@functools.lru_cache(maxsize=None)
def _ports(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=dev)


def ingress_step(arch: SwitchArch, table, keys: torch.Tensor, pids: torch.Tensor):
    """One cycle's ingress on the arrivals ``pids`` [N] (-1 none): parse,
    learn src -> port, look the routing key up.  -> (table, out_port [N]
    int64: the port, -2 broadcast on a miss, -1 on an invalid lane)."""
    valid = pids >= 0
    fields = keys[torch.clamp(pids, min=0)]               # [N, 2]
    dst_key, src_key = fields[:, 0], fields[:, 1]
    # learn then lookup (learning on every arrival, §III-B.2)
    table = ft.learn(arch, table, src_key, _ports(arch.n_ports, pids.device), valid)
    return table, ft.lookup(arch, table, dst_key, valid)


def _init_egress(arch: SwitchArch, npkt: int, dev) -> _Egress:
    n = arch.n_ports
    z = lambda *s: torch.zeros(s, dtype=torch.int64, device=dev)  # noqa: E731
    return _Egress(
        voq=vq.init_voq(arch, npkt, dev),
        sched=sch.init_sched(arch, dev),
        busy_in=z(n),
        busy_out=z(n),
        dep_cycle=torch.full((max(npkt, 1),), -1, dtype=torch.int64, device=dev),
        delivered=z(),
        occ_max=z(n, n),
        data_max=z(),
    )


def egress_step(arch: SwitchArch, c: _Egress, size_flits: torch.Tensor,
                cyc: torch.Tensor, pids: torch.Tensor, out_port: torch.Tensor,
                valid: torch.Tensor):
    """One cycle's egress: enqueue the lanes ``valid`` marks to ``out_port``
    (a port, -2 broadcast, anything else no queue), schedule, dequeue the
    matched heads, hold their ports busy, record departures.  ->
    (state, the cycle's largest queue occupancy after the enqueue)."""
    voq = vq.enqueue(arch, c.voq, pids, out_port, valid)
    occ = vq.occupancy(voq)
    match, sched = sch.schedule(arch, c.sched, occ, c.busy_in > 0, c.busy_out > 0)
    voq, dep_pid, dep_in = vq.dequeue(arch, voq, match)
    if arch.sched is SchedulerKind.EDRRM:
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
    return (_Egress(voq, sched, busy_in, busy_out, c.dep_cycle, delivered, occ_max,
                    data_max), occ.amax())


def _out(c: _Egress, occ_trace: torch.Tensor) -> SwitchLoopOut:
    return SwitchLoopOut(c.dep_cycle, occ_trace, c.occ_max, c.delivered, c.voq.drops,
                         c.data_max)


def ingress_ref(arch: SwitchArch, arr_pid: torch.Tensor, words: torch.Tensor,
                key_slices: Baked) -> torch.Tensor:
    """Every cycle's ingress: arr_pid [T, N], words [npkt, W], the routing
    and src keys' baked slices -> the lookup's ``out`` [T, N] int32 (the
    port, -2 broadcast, -1 no packet), on arr_pid's device.  The plain
    version of the kernel's ingress pass."""
    dev = arr_pid.device
    keys = _keys(key_slices, words, dev)
    table = ft.init_table(arch, dev)
    arr = arr_pid.to(torch.int64)
    out = torch.empty(arr.shape, dtype=torch.int32, device=dev)
    for k in range(arr.shape[0]):
        table, out[k] = ingress_step(arch, table, keys, arr[k])
    return out


def egress_ref(arch: SwitchArch, arr_pid: torch.Tensor, out: torch.Tensor,
               valid: torch.Tensor, size_flits: torch.Tensor) -> SwitchLoopOut:
    """Every cycle's egress: arr_pid [T, N], the hooked ``out`` [T, N] (any
    integer dtype) and ``valid`` [T, N] bool, size_flits [npkt] ->
    ``SwitchLoopOut``, on arr_pid's device.  The plain version of the
    kernel's egress pass."""
    dev = arr_pid.device
    size_flits = size_flits.to(dev, torch.int64)
    c = _init_egress(arch, size_flits.shape[0], dev)
    arr, out = arr_pid.to(torch.int64), out.to(dev, torch.int64)
    valid = valid.to(dev, torch.bool)
    t = arr.shape[0]
    cycles = torch.arange(t, dtype=torch.int64, device=dev)
    occ_trace = torch.empty((t,), dtype=torch.int64, device=dev)
    for k in range(t):
        c, occ_trace[k] = egress_step(arch, c, size_flits, cycles[k], arr[k], out[k],
                                      valid[k])
    return _out(c, occ_trace)


def switch_loop_ref(arch: SwitchArch, arr_pid: torch.Tensor, words: torch.Tensor,
                    size_flits: torch.Tensor, key_slices: Baked) -> SwitchLoopOut:
    """arr_pid [T, N] (arriving packet id per cycle and port, -1 none), words
    [npkt, W] (packed headers), size_flits [npkt], the routing and src keys'
    baked slices -> every cycle of the switch, on arr_pid's device: a
    cycle's ingress, the custom kernels' hooks, then its egress."""
    dev = arr_pid.device
    keys = _keys(key_slices, words, dev)
    size_flits = size_flits.to(dev, torch.int64)
    table = ft.init_table(arch, dev)
    c = _init_egress(arch, words.shape[0], dev)
    kstates = hooks.initial_states(arch)
    n_cycles = arr_pid.shape[0]
    arr = arr_pid.to(torch.int64)
    cycles = torch.arange(n_cycles, dtype=torch.int64, device=dev)
    occ_trace = torch.empty((n_cycles,), dtype=torch.int64, device=dev)
    for k in range(n_cycles):
        pids, cyc = arr[k], cycles[k]
        table, out_port = ingress_step(arch, table, keys, pids)
        out_port, valid = hooks.step(arch, kstates, pids, out_port, pids >= 0, cyc)
        c, occ_trace[k] = egress_step(arch, c, size_flits, cyc, pids, out_port, valid)
    return _out(c, occ_trace)
