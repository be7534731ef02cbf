"""Plain PyTorch statements of the mixer's fused glue (``csrc/mamba_glue.cu``).

The forwards are the plain code of ``models/mamba2.py`` ``apply_mamba``, which
runs them on CPU and meta tensors (``ops.py``): ``conv_silu_heads_ref`` is the
causal conv (``causal_conv``), SiLU in float32 and the transpose into the SSD
scan's layout; ``skip_gate_norm_ref`` is the dskip add, the transpose back to
token order and the gated norm (``gated_norm``, which the decode step shares).
``chip_smoke.py`` and the card tests hold the kernels against them.

The gradients are stated in float32 as the kernels compute them: each
forward recomputed from the saved inputs, one rounding of each output to the
activation dtype, float32 sums.  They are the card kernels' oracle; the CPU
tests hold them against autograd of the plain forwards.

Shapes: xi, z, out [B, S, di]; w [di, K]; xh, y [B·H, S, P]; dskip [H];
norm_g [di]; rstd [B·S].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["causal_conv", "gated_norm", "conv_silu_heads_ref", "skip_gate_norm_ref",
           "conv_silu_heads_bwd_ref", "skip_gate_norm_bwd_ref", "to_heads", "to_tokens"]

_F32 = torch.float32


def to_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H·P] -> [B·H, S, P]."""
    b, s, di = x.shape
    p = di // heads
    return x.reshape(b, s, heads, p).transpose(1, 2).reshape(b * heads, s, p)


def to_tokens(x: torch.Tensor, b: int) -> torch.Tensor:
    """[B·H, S, P] -> [B, S, H·P]."""
    bh, s, p = x.shape
    h = bh // b
    return x.reshape(b, h, s, p).transpose(1, 2).reshape(b, s, h * p)


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq: x [B, S, C], w [C, K] (the
    reference's unrolled shifts, taps K-1 down to 0 from a zero start; the
    sum is float32 once w is)."""
    k = w.shape[-1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i: i + x.shape[1]] * w[:, k - 1 - i]
    return out


def gated_norm(y: torch.Tensor, z: torch.Tensor, norm_g: torch.Tensor, eps: float,
               dtype) -> torch.Tensor:
    """(y · silu(z)) normed by its RMS over the last axis, times norm_g, in
    ``dtype``."""
    y = y * F.silu(z.to(_F32)).to(y.dtype)
    yf = y.to(_F32)
    return (yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + eps) * norm_g).to(dtype)


def conv_silu_heads_ref(xi: torch.Tensor, w: torch.Tensor, heads: int) -> torch.Tensor:
    """xh [B·H, S, P] = silu(conv(xi)) rounded to xi's dtype."""
    return to_heads(F.silu(causal_conv(xi, w).to(_F32)).to(xi.dtype), heads)


def _per_head(dskip: torch.Tensor, b: int, like: torch.Tensor) -> torch.Tensor:
    """D[h] spread over the heads' layout [B·H, S, P] of ``like``."""
    h = dskip.shape[0]
    return dskip[None, :, None, None].expand(b, h, *like.shape[1:]).reshape(like.shape)


def skip_gate_norm_ref(y, xh, z, dskip, norm_g, eps: float) -> torch.Tensor:
    """out [B, S, di] in z's dtype: (y + xh·D)·silu(z), RMS over di, norm_g."""
    b = z.shape[0]
    u = to_tokens(y + xh * _per_head(dskip, b, y), b)
    return gated_norm(u, z, norm_g, eps, z.dtype)


def _silu_grad(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    s = 1.0 / (1.0 + torch.exp(-x))
    return dy * s * (1.0 + x * (1.0 - s))


def conv_silu_heads_bwd_ref(xi: torch.Tensor, w: torch.Tensor, dxh: torch.Tensor):
    """(dxi in xi's dtype, dw [di, K] float32): dpre = dxh·silu'(pre),
    dxi[t] = sum_j dpre[t + j]·w[j], dw[:, j] = sum over B and t of
    dpre[t]·xi[t - j]."""
    b, s, _ = xi.shape
    k = w.shape[-1]
    x = xi.to(_F32)
    dpre = _silu_grad(to_tokens(dxh.to(_F32), b), causal_conv(x, w.to(_F32)))
    ahead = F.pad(dpre, (0, 0, 0, k - 1))            # dpre[t + j], zero past the end
    behind = F.pad(x, (0, 0, k - 1, 0))              # xi[t - j], zero before the start
    dxi = sum(ahead[:, j: j + s] * w[:, j] for j in range(k))
    dw = torch.stack([(dpre * behind[:, k - 1 - j: k - 1 - j + s]).sum((0, 1))
                      for j in range(k)], dim=-1)
    return dxi.to(xi.dtype), dw


def skip_gate_norm_bwd_ref(dout, y, xh, z, dskip, norm_g, eps: float):
    """(dy, dxh's skip term, dz in z's dtype, ddskip [H], dnorm_g [di]
    float32) for the incoming gradient ``dout`` [B, S, di]."""
    b, _, di = z.shape
    h = dskip.shape[0]
    d = _per_head(dskip, b, y)
    u = to_tokens(y.to(_F32) + xh.to(_F32) * d, b)
    zf = z.to(_F32)
    sz = F.silu(zf)
    v = u * sz
    r = torch.rsqrt(torch.mean(v * v, -1, keepdim=True) + eps)
    do = dout.to(_F32)
    dh = do * norm_g
    dg = (do * (v * r)).sum((0, 1))
    dot = (dh * v).sum(-1, keepdim=True)
    dv = dh * r + 2.0 * ((-0.5 * dot) * r ** 3 / di) * v
    du = dv * sz
    dz = _silu_grad(dv * u, zf)
    du_h = to_heads(du, h)
    ddskip = (du_h * xh.to(_F32)).reshape(b, h, -1).sum((0, 2))
    return du_h.to(y.dtype), (du_h * d).to(xh.dtype), dz.to(z.dtype), ddskip, dg
