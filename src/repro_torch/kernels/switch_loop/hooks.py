"""The custom kernels' hooks (§III-B.5), stepped once a cycle on the host.

A ``CustomKernelSpec``'s ``fn`` is Python, which no CUDA kernel can call.
The hook sits between a cycle's ingress (the forward table's learn and
lookup) and its egress (the VOQs onward), and its inputs depend only on the
arrivals: so on a card the switch runs every cycle's ingress in one launch,
then ``run_hooks`` steps the hooks over the cycles here, then every cycle's
egress in a second launch (``ops.switch_loop``).  The result is the eager
loop's bit for bit (``ref.switch_loop_ref``, which calls the same ``step``
between the same two steps).

The ``fn`` contract (``core/archspec.CustomKernelSpec``): called on every
cycle, idle ones too, each spec in order, as
``fn(state, pids, out_port, valid, cyc) -> (state, out_port, valid)`` on CPU
tensors of the dtypes the eager loop passes on the CPU (int64 ``pids`` and
``out_port`` [N], bool ``valid`` [N], a 0-d int64 ``cyc``); ``state``
starts as the spec's ``init_state`` (None without one) and is passed
through unchanged from one cycle to the next.  ``fn`` must not write into
its arguments.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core.archspec import SwitchArch

__all__ = ["has_hooks", "initial_states", "run_hooks", "step"]


def has_hooks(arch: SwitchArch) -> bool:
    """Whether some custom kernel of ``arch`` carries a Python ``fn``."""
    return any(k.fn is not None for k in arch.custom_kernels)


def initial_states(arch: SwitchArch) -> List:
    """Each custom kernel's state before cycle 0 (None without an ``init_state``)."""
    return [getattr(k, "init_state", None) for k in arch.custom_kernels]


def step(arch: SwitchArch, states: List, pids: torch.Tensor, out_port: torch.Tensor,
         valid: torch.Tensor, cyc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cycle of the hooks: each spec's ``fn`` in order, ``states``
    updated in place -> the hooked (out_port, valid)."""
    for i, k in enumerate(arch.custom_kernels):
        if k.fn is not None:
            states[i], out_port, valid = k.fn(states[i], pids, out_port, valid, cyc)
    return out_port, valid


def run_hooks(arch: SwitchArch, arr_pid: torch.Tensor,
              out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step ``arch``'s hooks over every cycle.  ``arr_pid`` [T, N] (-1 no
    packet) and ``out`` [T, N] (the ingress lookup's ports: -1 invalid, -2
    broadcast) on the CPU -> the hooked ``out`` [T, N] int64 and ``valid``
    [T, N] bool, on the CPU."""
    pids = arr_pid.to(torch.int64)
    out_in = out.to(torch.int64)
    valid_in = pids >= 0
    out_h, valid_h = torch.empty_like(out_in), torch.empty_like(valid_in)
    states = initial_states(arch)
    cycles = torch.arange(pids.shape[0], dtype=torch.int64)
    for k in range(pids.shape[0]):
        out_h[k], valid_h[k] = step(arch, states, pids[k], out_in[k], valid_in[k],
                                    cycles[k])
    return out_h, valid_h
