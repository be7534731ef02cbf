"""Binding of the hand-written iSLIP kernel (``csrc/islip.cu``).

Replaces the JAX package's Pallas tile ``kernels/islip/kernel.py``
(``_islip_kernel``, ``islip_schedule_padded``).  One warp per switch
instance, lane = port, the matching held as register bitmasks; bound by
operations and, at the switch's batch of one, by launch latency (see the
note at the top of the CUDA source).

Contract: ``req`` [B, N, N] int32 0/1, ``gptr``/``aptr`` [B, N] int32,
``iters`` → ``(match [B, N, N] int32, gptr', aptr')``, bitwise equal to
``ref.islip_ref``.  N <= 32.  The wrapper never synchronises: the switch
calls it once per simulated cycle, so it checks shapes, dtypes and devices
only, not values.  ``LAUNCHES`` counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import check_launch, check_tensor, library

__all__ = ["LAUNCHES", "MAX_PORTS", "islip_launch"]

#: kernel launches since the counter was last reset (``chip_smoke.py`` sets
#: it to 0 before the main path and reads it after)
LAUNCHES = 0
#: one lane per port
MAX_PORTS = 32

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = library("islip")
    if not getattr(lib, "_spac_typed", False):
        lib.islip_schedule_i32.argtypes = [_P] * 6 + [_I, _I, _I, _P]
        lib.islip_schedule_i32.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def islip_launch(req: torch.Tensor, gptr: torch.Tensor, aptr: torch.Tensor,
                 *, iters: int):
    """Launch the matching on ``req``'s CUDA device."""
    global LAUNCHES
    if req.device.type != "cuda":
        raise ValueError(f"islip_launch launches a CUDA kernel; got a tensor on "
                         f"{req.device} (the plain version is ref.py)")
    if req.dim() != 3 or req.shape[1] != req.shape[2]:
        raise ValueError(f"req must be [B, N, N], got {tuple(req.shape)}")
    b, n, _ = req.shape
    if not 1 <= n <= MAX_PORTS:
        raise ValueError(f"the iSLIP kernel takes 1..{MAX_PORTS} ports, got {n}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    dev = req.device
    check_tensor(req, "req", torch.int32, (b, n, n), dev)
    check_tensor(gptr, "gptr", torch.int32, (b, n), dev)
    check_tensor(aptr, "aptr", torch.int32, (b, n), dev)
    match = torch.empty((b, n, n), dtype=torch.int32, device=dev)
    gout = torch.empty((b, n), dtype=torch.int32, device=dev)
    aout = torch.empty((b, n), dtype=torch.int32, device=dev)
    if b == 0:
        return match, gout, aout
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.islip_schedule_i32(req.data_ptr(), gptr.data_ptr(),
                                      aptr.data_ptr(), match.data_ptr(),
                                      gout.data_ptr(), aout.data_ptr(), b, n,
                                      iters, stream)
    check_launch(code, "islip_launch")
    LAUNCHES += 1
    return match, gout, aout
