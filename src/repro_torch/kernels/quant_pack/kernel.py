"""Binding of the hand-written int8 quantize/dequantize kernels
(``csrc/quant_pack.cu``).

Replaces the JAX package's Pallas kernels ``kernels/quant_pack/kernel.py``
``quantize`` and ``dequantize``.  One warp per 128-element group, 4
elements per lane, vector loads and stores; bound by bytes (see the note at
the top of the CUDA source).

Contract: ``quantize(x)`` for ``x`` [R, C] float32 or bfloat16 (C % 128 ==
0) gives ``(q int8 [R, C], s float32 [R, C / 128])`` and
``dequantize(q, s, out_dtype)`` gives ``[R, C]`` float32 or bfloat16, both
bitwise equal to ``ref.py``.  ``QUANTIZE_LAUNCHES`` and
``DEQUANTIZE_LAUNCHES`` count the launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import check_launch, check_no_grad, check_tensor, library
from .ref import GROUP

__all__ = ["QUANTIZE_LAUNCHES", "DEQUANTIZE_LAUNCHES", "quantize",
           "dequantize"]

#: kernel launches since the counters were last reset (``chip_smoke.py``
#: sets them to 0 before the main path and reads them after)
QUANTIZE_LAUNCHES = 0
DEQUANTIZE_LAUNCHES = 0

_P = ctypes.c_void_p
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _lib():
    lib = library("quant_pack")
    if not getattr(lib, "_spac_typed", False):
        for name in ("quantize_f32", "quantize_bf16", "dequantize_f32",
                     "dequantize_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [_P, _P, _P, ctypes.c_longlong, _P]
            fn.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def _check_aligned(x: torch.Tensor, name: str) -> None:
    """The kernels move each lane's 4 elements in one vector access."""
    if x.data_ptr() % (4 * x.element_size()):
        raise ValueError(f"{name} must start on a {4 * x.element_size()}-byte "
                         "boundary")


def _check_2d(x: torch.Tensor, name: str) -> tuple:
    if x.device.type != "cuda":
        raise ValueError(f"{name} is on {x.device}: the quant_pack kernels "
                         "take CUDA tensors (the plain version is ref.py)")
    if x.dim() != 2 or x.shape[1] % GROUP:
        raise ValueError(f"{name} must be [R, C] with C % {GROUP} == 0, got "
                         f"{tuple(x.shape)}")
    return tuple(x.shape)


def quantize(x: torch.Tensor):
    """Launch the quantize kernel on ``x``'s CUDA device."""
    global QUANTIZE_LAUNCHES
    check_no_grad("quantize", x)
    r, c = _check_2d(x, "x")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"x has dtype {x.dtype}; the kernel takes float32 or "
                         "bfloat16")
    check_tensor(x, "x", x.dtype, (r, c), x.device)
    _check_aligned(x, "x")
    q = torch.empty((r, c), dtype=torch.int8, device=x.device)
    s = torch.empty((r, c // GROUP), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return q, s
    fn = getattr(_lib(), "quantize_" + _SUFFIX[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), s.numel(), stream)
    check_launch(code, "quantize")
    QUANTIZE_LAUNCHES += 1
    return q, s


def dequantize(q: torch.Tensor, s: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the dequantize kernel on ``q``'s CUDA device."""
    global DEQUANTIZE_LAUNCHES
    check_no_grad("dequantize", q, s)
    r, c = _check_2d(q, "q")
    if out_dtype not in _SUFFIX:
        raise ValueError(f"out_dtype {out_dtype}: the kernel writes float32 or "
                         "bfloat16")
    check_tensor(q, "q", torch.int8, (r, c), q.device)
    check_tensor(s, "s", torch.float32, (r, c // GROUP), q.device)
    _check_aligned(q, "q")
    out = torch.empty((r, c), dtype=out_dtype, device=q.device)
    if q.numel() == 0:
        return out
    fn = getattr(_lib(), "dequantize_" + _SUFFIX[out_dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), s.data_ptr(), out.data_ptr(), s.numel(), stream)
    check_launch(code, "dequantize")
    DEQUANTIZE_LAUNCHES += 1
    return out
