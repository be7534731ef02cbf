"""Public ops of the mixer's fused glue: ``conv_silu_heads`` and
``skip_gate_norm``, on either side of the SSD scan in ``apply_mamba``.

Device policy: CUDA tensors launch the hand-written kernels through
``ConvSiluHeadsFn`` and ``SkipGateNormFn``, whose backwards launch the
gradient kernels; CPU and meta tensors take the plain versions (``ref.py``),
which autograd differentiates as they are (``build.takes_plain``).  A CUDA
form the kernels do not take raises (``kernel.py``): nothing falls back to
the plain code on the card.
"""

from __future__ import annotations

import torch

from ..build import takes_plain
from . import kernel
from .ref import conv_silu_heads_ref, skip_gate_norm_ref

__all__ = ["ConvSiluHeadsFn", "SkipGateNormFn", "conv_silu_heads", "skip_gate_norm"]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, copied where it does not start on a 16-byte boundary
    (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class ConvSiluHeadsFn(torch.autograd.Function):
    """xi [B, S, di] -> xh [B·H, S, P] on the card, with its gradient (the
    bias's too, where there is one)."""

    @staticmethod
    def forward(ctx, xi, conv_w, heads, bias):
        ctx.save_for_backward(xi, conv_w, bias)
        return kernel.conv_silu_heads(xi, conv_w, heads, bias)

    @staticmethod
    def backward(ctx, dxh):
        xi, conv_w, bias = ctx.saved_tensors
        grads = kernel.conv_silu_heads_bwd(xi, conv_w, _aligned(dxh), bias)
        return grads[0], grads[1], None, grads[2] if bias is not None else None


class SkipGateNormFn(torch.autograd.Function):
    """(y, xh, z) -> the gated, normed [B, S, di] on the card, with its
    gradient (from the saved inputs and each row's and group's rsqrt)."""

    @staticmethod
    def forward(ctx, y, xh, z, dskip, norm_g, eps, groups):
        out, rstd = kernel.skip_gate_norm(y, xh, z, dskip, norm_g, eps, groups)
        ctx.save_for_backward(y, xh, z, dskip, norm_g, rstd)
        ctx.groups = groups
        return out

    @staticmethod
    def backward(ctx, dout):
        y, xh, z, dskip, norm_g, rstd = ctx.saved_tensors
        grads = kernel.skip_gate_norm_bwd(_aligned(dout), y, xh, z, dskip, norm_g, rstd,
                                          ctx.groups)
        return (*grads, None, None)


def conv_silu_heads(xi: torch.Tensor, conv_w: torch.Tensor, heads: int,
                    bias=None) -> torch.Tensor:
    """xi [B, S, di] -> xh [B·H, S, P]: the causal conv (plus ``bias``, where
    given), SiLU in float32 and one rounding to xi's dtype, in the SSD
    scan's layout."""
    if takes_plain(xi):
        return conv_silu_heads_ref(xi, conv_w, heads, bias)
    return ConvSiluHeadsFn.apply(_aligned(xi), conv_w.contiguous(), heads,
                                 None if bias is None else bias.contiguous())


def skip_gate_norm(y, xh, z, dskip, norm_g, eps: float, groups: int = 1) -> torch.Tensor:
    """y, xh [B·H, S, P], z [B, S, di] -> [B, S, di] in z's dtype:
    ((y + xh·D)·silu(z)) normed by its RMS over each of ``groups`` equal
    groups of di, times norm_g."""
    if takes_plain(z):
        return skip_gate_norm_ref(y, xh, z, dskip, norm_g, eps, groups)
    return SkipGateNormFn.apply(_aligned(y), _aligned(xh), _aligned(z), dskip.contiguous(),
                                _aligned(norm_g), eps, groups)
