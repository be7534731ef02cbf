"""Public ops for payload compression (int8 codes + one float32 scale per
128-element group): the dispatch fabric's wire format.

Device policy: CUDA tensors launch the hand-written kernels
(``kernel.quantize``/``kernel.dequantize``) through ``QuantizeFn`` and
``DequantizeFn``, CPU and meta tensors take the plain PyTorch versions
(``ref.py``; ``build.takes_plain``), any other device raises; there is no
fallback from one to the other.

The gradient, as the reference's autodiff of ``quantize_ref`` and
``dequantize_ref`` gives it, flows only through the scale: ``round`` and the
int8 cast give zero, ``max(|x|) * float32(1/127)`` does not.  So
``dequantize``'s backward is ``ds = sum over the group of dy * q`` (q gets
none), and ``quantize``'s is ``dx = ds * float32(1/127)`` at each group's
largest |x| (with x's sign, shared evenly among ties; none where the
group's largest |x| is below 1e-30, where the scale is the constant
floor).  The CUDA path's Functions compute that closed form in plain
PyTorch; the CPU path's autograd of ``ref.py`` gives the same.
``compress``/``decompress`` round-trip a tensor of any shape by flattening
it to [R, 128] (zero-padded), as the JAX package's ``ops.py`` does.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..build import takes_plain
from . import kernel
from .ref import GROUP, dequantize_ref, quantize_ref

__all__ = ["GROUP", "QuantizeFn", "DequantizeFn", "quantize", "dequantize",
           "compress", "decompress", "compression_ratio"]


class QuantizeFn(torch.autograd.Function):
    """``kernel.quantize`` with the reference's gradient (through the
    scales only)."""

    @staticmethod
    def forward(ctx, x):
        q, s = kernel.quantize(x)
        ctx.mark_non_differentiable(q)
        ctx.save_for_backward(x)
        return q, s

    @staticmethod
    def backward(ctx, gq, gs):
        (x,) = ctx.saved_tensors
        r, c = x.shape
        g = x.to(torch.float32).reshape(r, c // GROUP, GROUP)
        mag = g.abs()
        absmax = mag.amax(-1, keepdim=True)
        at_max = (mag == absmax).to(torch.float32)
        share = at_max / at_max.sum(-1, keepdim=True)
        inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)
        ds = gs[..., None] * inv127 * (absmax >= 1e-30).to(torch.float32)
        return (ds * share * torch.sign(g)).reshape(r, c).to(x.dtype)


class DequantizeFn(torch.autograd.Function):
    """``kernel.dequantize`` with the reference's gradient (to the scales
    only)."""

    @staticmethod
    def forward(ctx, q, s, out_dtype):
        ctx.save_for_backward(q)
        return kernel.dequantize(q, s, out_dtype)

    @staticmethod
    def backward(ctx, gy):
        (q,) = ctx.saved_tensors
        r, c = q.shape
        g = gy.to(torch.float32).reshape(r, c // GROUP, GROUP)
        return None, (g * q.to(torch.float32).reshape(r, c // GROUP, GROUP)).sum(-1), None


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [R, C] (C % 128 == 0) -> (q int8 [R, C], scales float32 [R, C/128])."""
    if takes_plain(x):
        return quantize_ref(x)
    return QuantizeFn.apply(x.contiguous())


def dequantize(q: torch.Tensor, s: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(q, s) -> [R, C] ``out_dtype``."""
    if takes_plain(q):
        return dequantize_ref(q, s, out_dtype)
    return DequantizeFn.apply(q.contiguous(), s.contiguous(), out_dtype)


def _to_2d(x: torch.Tensor):
    shape = tuple(x.shape)
    flat = math.prod(shape)
    v = torch.nn.functional.pad(x.reshape(-1), (0, (-flat) % GROUP))
    return v.reshape(-1, GROUP), (shape, flat)


def compress(x: torch.Tensor):
    """tensor -> (q int8 [R, 128], scales float32 [R, 1], meta): the wire format."""
    v, meta = _to_2d(x)
    q, s = quantize(v)
    return q, s, meta


def decompress(q: torch.Tensor, s: torch.Tensor, meta, *,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    shape, flat = meta
    return dequantize(q, s, dtype).reshape(-1)[:flat].reshape(shape)


def compression_ratio(x: torch.Tensor) -> float:
    """Wire-bytes ratio vs the uncompressed dtype (the 'header compression' win)."""
    in_bytes = x.numel() * x.element_size()
    out_bytes = x.numel() * 1 + (x.numel() // GROUP) * 4
    return in_bytes / out_bytes
