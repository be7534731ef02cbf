"""Public cycle-loop op: every cycle of one cycle-level switch simulation.

Device policy: tensors on the CPU take the plain PyTorch version
(``ref.switch_loop_ref``, the eager loop, custom-kernel hooks included).
Tensors on a CUDA device launch the hand-written kernel: one fused launch
(``kernel.switch_loop_launch``) for an architecture without a Python
custom-kernel ``fn``; otherwise the ingress pass (``kernel.
switch_ingress_launch``), the hooks stepped once a cycle on the host
(``hooks.run_hooks``: one copy of the lookup's ports to the host, one copy
of the hooked ports and valid bits back), then the egress pass
(``kernel.switch_egress_launch``).  Both give the eager loop's result bit
for bit.  There is no fallback from one to the other: a failed build or
launch, or an exception in a hook, propagates.
"""

from __future__ import annotations

import torch

from . import hooks, kernel
from .ref import SwitchLoopOut, switch_loop_ref

__all__ = ["egress_inputs", "hooked_passes", "switch_loop"]

_I32 = torch.iinfo(torch.int32)


def _plain(x: torch.Tensor) -> bool:
    """Whether ``x``'s device takes the plain version (the CPU)."""
    return x.device.type == "cpu"


def switch_loop(arch, arr_pid, words, size_flits, key_slices):
    """arr_pid [T, N], words [npkt, W] (packed headers), size_flits [npkt],
    the routing and src keys' baked slices -> ``SwitchLoopOut``."""
    if _plain(arr_pid):
        return switch_loop_ref(arch, arr_pid, words, size_flits, key_slices)
    arr = arr_pid.to(torch.int32).contiguous()
    words = words.to(torch.uint32).contiguous()
    size_flits = size_flits.to(torch.int32).contiguous()
    if not hooks.has_hooks(arch):
        return kernel.switch_loop_launch(arch, arr, words, size_flits, key_slices)
    return hooked_passes(arch, arr, words, size_flits, key_slices)


def hooked_passes(arch, arr_pid, words, size_flits, key_slices) -> SwitchLoopOut:
    """The ingress pass, ``arch``'s hooks on the host, the egress pass, on
    ``arr_pid``'s device (int32 arr_pid and size_flits, uint32 words)."""
    out = kernel.switch_ingress_launch(arch, arr_pid, words, key_slices)
    out_d, valid_d = egress_inputs(*hooks.run_hooks(arch, arr_pid.cpu(), out.cpu()),
                                   arr_pid.device)
    return kernel.switch_egress_launch(arch, arr_pid, out_d, valid_d, size_flits)


def egress_inputs(out: torch.Tensor, valid: torch.Tensor, device):
    """The hooked ``out`` and ``valid`` as the egress pass takes them on
    ``device``: int32 and bool.  A hook may return any port value; one
    outside int32 queues nothing, and neither does it saturated."""
    return (out.clamp(_I32.min, _I32.max).to(torch.int32).to(device),
            valid.to(device, torch.bool))
