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

``simulate`` on the CPU runs this, and so does an architecture whose
custom kernel carries a Python ``fn``, which no CUDA kernel can call.
``chip_smoke.py`` holds the fused kernel against it on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.archspec import SchedulerKind, SwitchArch
from repro_torch.kernels.parser.ref import Baked, extract_fields
from repro_torch.switch import forward_table as ft
from repro_torch.switch import scheduler as sch
from repro_torch.switch import voq as vq

__all__ = ["SwitchLoopOut", "switch_loop_ref"]


class SwitchLoopOut(NamedTuple):
    dep_cycle: torch.Tensor       # [max(npkt, 1)] int64 last copy's departure cycle, -1 never
    occ_trace: torch.Tensor       # [T] int64 per-cycle max queue occupancy
    occ_max: torch.Tensor         # [N, N] int64 per-queue max occupancy
    delivered: torch.Tensor       # int64 scalar, copies delivered
    drops: torch.Tensor           # int64 scalar, copies dropped
    data_slots_max: torch.Tensor  # int64 scalar


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


def switch_loop_ref(arch: SwitchArch, arr_pid: torch.Tensor, words: torch.Tensor,
                    size_flits: torch.Tensor, key_slices: Baked) -> SwitchLoopOut:
    """arr_pid [T, N] (arriving packet id per cycle and port, -1 none), words
    [npkt, W] (packed headers), size_flits [npkt], the routing and src keys'
    baked slices -> every cycle of the switch, on arr_pid's device."""
    dev = arr_pid.device
    n = arch.n_ports
    npkt = words.shape[0]
    keys = torch.stack(extract_fields(key_slices, words.to(dev)), dim=1)   # [npkt, 2]
    size_flits = size_flits.to(dev, torch.int64)
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
    n_cycles = arr_pid.shape[0]
    arr = arr_pid.to(torch.int64)
    cycles = torch.arange(n_cycles, dtype=torch.int64, device=dev)
    occ_trace = torch.empty((n_cycles,), dtype=torch.int64, device=dev)
    for k in range(n_cycles):
        c, occ_peak = cycle_step(c, cycles[k], arr[k])
        occ_trace[k] = occ_peak
    return SwitchLoopOut(c.dep_cycle, occ_trace, c.occ_max, c.delivered,
                         c.voq.drops, c.data_max)
