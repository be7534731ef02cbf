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


def switch_loop(arch, arr_pid, words, size_flits, key_slices):
    """arr_pid [T, N], words [npkt, W] (packed headers), size_flits [npkt],
    the routing and src keys' baked slices -> ``SwitchLoopOut``."""
    if arr_pid.device.type == "cpu":
        return switch_loop_ref(arch, arr_pid, words, size_flits, key_slices)
    return kernel.switch_loop_launch(arch, arr_pid.to(torch.int32).contiguous(),
                                     words.to(torch.uint32).contiguous(),
                                     size_flits.to(torch.int32).contiguous(), key_slices)
