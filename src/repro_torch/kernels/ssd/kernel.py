"""Binding of the hand-written SSD scan (``csrc/ssd.cu``).

Replaces the JAX package's Pallas kernel ``kernels/ssd/kernel.py``
``ssd_scan``, at the call site of its XLA twin ``kernels/ssd/ops.py``
``ssd_chunked``.  One 256-thread block per head walks its chunks in order
with the [P, N] float32 state in shared memory; bound by operations (see
the note at the top of the CUDA source).

Contract: ``ssd_scan(x, dt, a, b, c, return_state=)`` for x [BH, S, P]
(float32 or bfloat16), dt [BH, S], a [BH] and b/c [G, S, N] float32 (G
divides BH; row g serves heads g·BH/G .. (g+1)·BH/G - 1), all contiguous on
one CUDA device, P in 32/64/128 and N in 16/32/64/128, gives y [BH, S, P] in
x's dtype (and the final state [BH, P, N] float32), equal to
``ref.ssd_chunked_ref`` up to float32 rounding.  ``LAUNCHES`` counts the
launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import check_launch, check_tensor, library

__all__ = ["LAUNCHES", "HEAD_DIMS", "STATE_DIMS", "ssd_scan"]

#: kernel launches since the counter was last reset (``chip_smoke.py`` sets
#: it to 0 before the main path and reads it after)
LAUNCHES = 0
HEAD_DIMS = (32, 64, 128)
STATE_DIMS = (16, 32, 64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _lib():
    lib = library("ssd")
    if not getattr(lib, "_spac_typed", False):
        for sfx in _SUFFIX.values():
            fn = getattr(lib, "ssd_scan_" + sfx)
            fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
            fn.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, return_state: bool = False):
    """Launch the kernel on ``x``'s CUDA device."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}: the SSD kernel takes CUDA tensors "
                         "(the plain version is ref.ssd_chunked_ref)")
    if x.dim() != 3 or b.dim() != 3:
        raise ValueError("x must be [BH, S, P] and b/c [G, S, N]")
    bh, s, p = x.shape
    g, n = b.shape[0], b.shape[-1]
    if x.dtype not in _SUFFIX:
        raise ValueError(f"x has dtype {x.dtype}; the kernel takes float32 or "
                         "bfloat16")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"P={p}, N={n}: the kernel takes P in {HEAD_DIMS} and "
                         f"N in {STATE_DIMS}")
    if g < 1 or bh % g:
        raise ValueError(f"{g} rows of B/C do not divide {bh} heads")
    dev = x.device
    check_tensor(x, "x", x.dtype, (bh, s, p), dev)
    check_tensor(dt, "dt", torch.float32, (bh, s), dev)
    check_tensor(a, "a", torch.float32, (bh,), dev)
    check_tensor(b, "b", torch.float32, (g, s, n), dev)
    check_tensor(c, "c", torch.float32, (g, s, n), dev)
    y = torch.empty_like(x)
    state = (torch.zeros((bh, p, n), dtype=torch.float32, device=dev)
             if return_state else None)
    if x.numel():
        fn = getattr(_lib(), "ssd_scan_" + _SUFFIX[x.dtype])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                      c.data_ptr(), y.data_ptr(),
                      state.data_ptr() if return_state else None,
                      bh, s, p, n, bh // g, stream)
        check_launch(code, "ssd_scan")
        LAUNCHES += 1
    return (y, state) if return_state else y
