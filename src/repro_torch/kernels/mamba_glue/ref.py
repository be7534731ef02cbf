"""Plain PyTorch statements of the mixer's fused glue (``csrc/mamba_glue.cu``).

The forwards are the plain code of ``models/mamba2.py`` ``apply_mamba``, which
runs them on CPU and meta tensors (``ops.py``): ``conv_silu_heads_ref`` is the
causal conv (``causal_conv``, plus a bias per channel where the mixer has
one), SiLU in float32 and the transpose into the SSD scan's layout;
``skip_gate_norm_ref`` is the dskip add, the transpose back to token order
and the gated norm (``gated_norm``, which the decode step shares), its RMS
taken over each of ``groups`` equal groups of channels (one: all of di).
``chip_smoke.py`` and the card tests hold the kernels against them.

The gradients are stated in float32 as the kernels compute them: each
forward recomputed from the saved inputs, one rounding of each output to the
activation dtype, float32 sums.  They are the card kernels' oracle; the CPU
tests hold them against autograd of the plain forwards.

Shapes: xi, z, out [B, S, di]; w [di, K]; bias [di]; xh, y [B·H, S, P];
dskip [H]; norm_g [di]; rstd [B·S·groups].
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


def _grouped(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[..., di] -> [..., groups, di / groups]."""
    return x.reshape(*x.shape[:-1], groups, x.shape[-1] // groups)


def gated_norm(y: torch.Tensor, z: torch.Tensor, norm_g: torch.Tensor, eps: float,
               dtype, groups: int = 1) -> torch.Tensor:
    """(y · silu(z)) normed by its RMS over each of ``groups`` equal groups
    of the last axis, times norm_g, in ``dtype``."""
    y = y * F.silu(z.to(_F32)).to(y.dtype)
    yg = _grouped(y.to(_F32), groups)
    yf = (yg * torch.rsqrt(torch.mean(yg * yg, -1, keepdim=True) + eps)).reshape(y.shape)
    return (yf * norm_g).to(dtype)


def _conv_pre(xi: torch.Tensor, w: torch.Tensor, bias) -> torch.Tensor:
    """The conv's float32 pre-activation: the taps' sum, then the bias."""
    pre = causal_conv(xi, w)
    return pre if bias is None else pre + bias


def conv_silu_heads_ref(xi: torch.Tensor, w: torch.Tensor, heads: int,
                        bias=None) -> torch.Tensor:
    """xh [B·H, S, P] = silu(conv(xi) + bias) rounded to xi's dtype."""
    return to_heads(F.silu(_conv_pre(xi, w, bias).to(_F32)).to(xi.dtype), heads)


def _per_head(dskip: torch.Tensor, b: int, like: torch.Tensor) -> torch.Tensor:
    """D[h] spread over the heads' layout [B·H, S, P] of ``like``."""
    h = dskip.shape[0]
    return dskip[None, :, None, None].expand(b, h, *like.shape[1:]).reshape(like.shape)


def skip_gate_norm_ref(y, xh, z, dskip, norm_g, eps: float, groups: int = 1) -> torch.Tensor:
    """out [B, S, di] in z's dtype: (y + xh·D)·silu(z), RMS over each group
    of di / ``groups`` channels, norm_g."""
    b = z.shape[0]
    u = to_tokens(y + xh * _per_head(dskip, b, y), b)
    return gated_norm(u, z, norm_g, eps, z.dtype, groups)


def _silu_grad(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    s = 1.0 / (1.0 + torch.exp(-x))
    return dy * s * (1.0 + x * (1.0 - s))


def conv_silu_heads_bwd_ref(xi: torch.Tensor, w: torch.Tensor, dxh: torch.Tensor, bias=None):
    """(dxi in xi's dtype, dw [di, K] float32), and with a ``bias`` its
    gradient dbias [di] float32 third: dpre = dxh·silu'(pre), dxi[t] =
    sum_j dpre[t + j]·w[j], dw[:, j] = sum over B and t of dpre[t]·xi[t - j],
    dbias = sum over B and t of dpre[t]."""
    b, s, _ = xi.shape
    k = w.shape[-1]
    x = xi.to(_F32)
    dpre = _silu_grad(to_tokens(dxh.to(_F32), b), _conv_pre(x, w.to(_F32), bias))
    ahead = F.pad(dpre, (0, 0, 0, k - 1))            # dpre[t + j], zero past the end
    behind = F.pad(x, (0, 0, k - 1, 0))              # xi[t - j], zero before the start
    dxi = sum(ahead[:, j: j + s] * w[:, j] for j in range(k))
    dw = torch.stack([(dpre * behind[:, k - 1 - j: k - 1 - j + s]).sum((0, 1))
                      for j in range(k)], dim=-1)
    if bias is not None:
        return dxi.to(xi.dtype), dw, dpre.sum((0, 1))
    return dxi.to(xi.dtype), dw


def skip_gate_norm_bwd_ref(dout, y, xh, z, dskip, norm_g, eps: float, groups: int = 1):
    """(dy, dxh's skip term, dz in z's dtype, ddskip [H], dnorm_g [di]
    float32) for the incoming gradient ``dout`` [B, S, di]; each group's
    sums, and its 1/gs, gs = di / ``groups``."""
    b, _, di = z.shape
    h, gs = dskip.shape[0], di // groups
    d = _per_head(dskip, b, y)
    u = to_tokens(y.to(_F32) + xh.to(_F32) * d, b)
    zf = z.to(_F32)
    sz = F.silu(zf)
    v = u * sz
    vg = _grouped(v, groups)
    r = torch.rsqrt(torch.mean(vg * vg, -1, keepdim=True) + eps)
    do = dout.to(_F32)
    dh = do * norm_g
    dg = (do * (vg * r).reshape(v.shape)).sum((0, 1))
    dot = (_grouped(dh, groups) * vg).sum(-1, keepdim=True)
    dv = (_grouped(dh, groups) * r + 2.0 * ((-0.5 * dot) * r ** 3 / gs) * vg).reshape(v.shape)
    du = dv * sz
    dz = _silu_grad(dv * u, zf)
    du_h = to_heads(du, h)
    ddskip = (du_h * xh.to(_F32)).reshape(b, h, -1).sum((0, 2))
    return du_h.to(y.dtype), (du_h * d).to(xh.dtype), dz.to(z.dtype), ddskip, dg
