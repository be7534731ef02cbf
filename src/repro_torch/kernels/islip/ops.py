"""Public batched-iSLIP op.

Device policy: tensors on a CUDA device launch the hand-written kernel
(``kernel.islip_launch``); tensors on the CPU take the plain PyTorch
version (``ref.islip_ref``).  There is no fallback from one to the other.
The JAX package's padding of N to the 128-lane boundary has no counterpart:
a warp holds up to 32 ports.
"""

from __future__ import annotations

import torch

from . import kernel
from .ref import islip_ref

__all__ = ["islip_schedule"]


def islip_schedule(req, gptr, aptr, *, iters: int = 2):
    """req [B, N, N] -> (match [B, N, N] int32, gptr', aptr' [B, N] int32)."""
    if req.device.type == "cpu":
        return islip_ref(req, gptr, aptr, iters=iters)
    return kernel.islip_launch(req.to(torch.int32).contiguous(),
                               gptr.to(torch.int32).contiguous(),
                               aptr.to(torch.int32).contiguous(), iters=iters)
