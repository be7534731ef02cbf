"""Public cycle-loop op: every cycle of one cycle-level switch simulation.

Device policy: tensors on a CUDA device launch the hand-written kernel
(``kernel.switch_loop_launch``, one launch per simulation); tensors on the
CPU take the plain PyTorch version (``ref.switch_loop_ref``, the eager loop).
There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import switch_loop_ref

__all__ = ["switch_loop"]


def switch_loop(arch, arr_pid, keys, size_flits):
    """arr_pid [T, N], keys [npkt, 2] (routing, src), size_flits [npkt]
    -> ``SwitchLoopOut``."""
    if arr_pid.device.type == "cpu":
        return switch_loop_ref(arch, arr_pid, keys, size_flits)
    return kernel.switch_loop_launch(arch, arr_pid.to(torch.int32).contiguous(),
                                     keys.to(torch.uint32).contiguous(),
                                     size_flits.to(torch.int32).contiguous())
