"""The plain reference's shared pieces: float32 arithmetic with TF32 off,
the fp8 operand rounding of the control, and the parts of a training step
that every family shares (normalisation, the loss, clipping, AdamW).

Nothing here imports the program.  Parameters are a flat dict of leaves
named as in the program's tree, one leaf per layer ("layers.3.attn.wq");
each leaf carries whether the program's optimizer decays it.

Precision: ``Prec.F32`` runs every product in float32.  ``Prec.FP8`` is the
control: the reference with every product's operands (and, in the
backward, the incoming gradient) rounded to float8 e4m3 with one absmax
scale per tensor, the way an fp8 training step feeds its tensor cores; the
rest stays in float32.
"""

from __future__ import annotations

import contextlib
import enum
import math
from typing import Callable, Dict, Sequence

import torch
import torch.utils.checkpoint

__all__ = ["Prec", "tf32_off", "fq", "gq", "mm", "rms_norm", "cross_entropy",
           "clip_scale", "adamw_leaf", "lr_at", "checkpointed", "gather", "E4M3_MAX"]

f32 = torch.float32
E4M3_MAX = 448.0


class Prec(enum.Enum):
    F32 = "f32"
    FP8 = "fp8"


@contextlib.contextmanager
def tf32_off():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _round_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one absmax scale, back in float32."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)


class _Fq(torch.autograd.Function):
    """Forward: the value rounded to e4m3.  Backward: the gradient as is."""

    @staticmethod
    def forward(ctx, t):
        return _round_e4m3(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _Gq(torch.autograd.Function):
    """Forward: the value as is.  Backward: the gradient rounded to e4m3."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round_e4m3(g)


def fq(t: torch.Tensor, prec: Prec) -> torch.Tensor:
    """A product's operand: rounded to e4m3 under the control."""
    return _Fq.apply(t) if prec is Prec.FP8 else t


def gq(t: torch.Tensor, prec: Prec) -> torch.Tensor:
    """A product's result: its incoming gradient rounded under the control."""
    return _Gq.apply(t) if prec is Prec.FP8 else t


def mm(x: torch.Tensor, w: torch.Tensor, prec: Prec) -> torch.Tensor:
    """``x @ w`` with both operands (and the gradient of the result) at the
    reference's precision."""
    return gq(torch.matmul(fq(x, prec), fq(w, prec)), prec)


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


class _CrossEntropy(torch.autograd.Function):
    """Mean next-token cross-entropy of ``h @ w`` over the labels >= 0,
    computed ``rows`` rows at a time; the backward computes each block's
    logits again, so no [T, V] tensor is ever whole."""

    @staticmethod
    def forward(ctx, h, w, labels, rows: int, fp8: bool):
        n = torch.clamp((labels >= 0).sum().float(), min=1.0)
        total = torch.zeros((), dtype=f32, device=h.device)
        wq = _round_e4m3(w) if fp8 else w
        for i in range(0, h.shape[0], rows):
            hb = h[i:i + rows]
            lb = labels[i:i + rows]
            logits = (_round_e4m3(hb) if fp8 else hb) @ wq
            nll = torch.logsumexp(logits, -1) - logits.gather(-1, lb.clamp(min=0)[:, None])[:, 0]
            total = total + torch.where(lb >= 0, nll, 0.0).sum()
        ctx.save_for_backward(h, w, labels, n)
        ctx.rows, ctx.fp8 = rows, fp8
        return total / n

    @staticmethod
    def backward(ctx, gout):
        h, w, labels, n = ctx.saved_tensors
        rows, fp8 = ctx.rows, ctx.fp8
        wq = _round_e4m3(w) if fp8 else w
        dh = torch.empty_like(h)
        dw = torch.zeros_like(w)
        for i in range(0, h.shape[0], rows):
            hb = h[i:i + rows]
            lb = labels[i:i + rows]
            hq = _round_e4m3(hb) if fp8 else hb
            p = torch.softmax(hq @ wq, -1)
            keep = (lb >= 0)
            p = p * keep[:, None]
            p[torch.arange(lb.shape[0], device=lb.device), lb.clamp(min=0)] -= keep.to(f32)
            dl = p * (gout / n)
            if fp8:
                dl = _round_e4m3(dl)
            dh[i:i + rows] = dl @ wq.T
            dw += hq.T @ dl
        return dh, dw, None, None, None


def cross_entropy(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                  prec: Prec, rows: int = 2048) -> torch.Tensor:
    """h [T, d], w [d, V], labels [T] -> the mean NLL over labels >= 0."""
    return _CrossEntropy.apply(h, w, labels, rows, prec is Prec.FP8)


def clip_scale(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """The factor that brings the global norm down to ``max_norm``."""
    gn = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)).float()
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def lr_at(hp: Dict, step: int) -> float:
    """The learning rate of step ``step``: linear warm-up over
    ``warmup_steps``, then flat, then (``schedule`` "wsd") a linear decay to
    a tenth over the last tenth of ``total_steps``."""
    if hp["schedule"] != "wsd":
        raise ValueError(f"schedule {hp['schedule']!r}: the reference knows wsd")
    warm = min(step / max(hp["warmup_steps"], 1), 1.0)
    start = 0.9 * hp["total_steps"]
    frac = min(max((step - start) / (0.1 * hp["total_steps"]), 0.0), 1.0)
    return hp["lr"] * warm * (1.0 - frac * 0.9)


def adamw_leaf(p, g, mu, nu, count: int, lr: float, hp: Dict, decay: bool):
    """One AdamW update of one leaf in place (float32): bias-corrected
    moments, decoupled weight decay where ``decay``."""
    b1, b2, eps, wd = hp["b1"], hp["b2"], hp["eps"], hp["weight_decay"]
    mu.mul_(b1).add_(g, alpha=1 - b1)
    nu.mul_(b2).addcmul_(g, g, value=1 - b2)
    a = lr * math.sqrt(1 - b2 ** count) / (1 - b1 ** count)
    step = a * mu / (torch.sqrt(nu) + eps)
    if decay and wd:
        step = step + lr * wd * p
    p.sub_(step)


def checkpointed(fn: Callable, *args):
    """``fn(*args)`` whose activations are computed again in the backward."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def gather(leaves: Dict[str, torch.Tensor], index: Dict[str, torch.Tensor],
           scale: float = 1.0) -> torch.Tensor:
    """The indexed elements of the leaves (stacked, or split by layer as
    ``per_layer`` names them), in float32 on the host, in ``index``'s
    order."""
    parts = []
    for name, idx in index.items():
        if name in leaves:
            parts.append(leaves[name].reshape(-1)[idx].float())
            continue
        rest, i = name[len("layers."):], 0
        per = leaves[f"layers.0.{rest}"].numel()
        while f"layers.{i}.{rest}" in leaves:
            parts.append(leaves[f"layers.{i}.{rest}"].reshape(-1)[idx[idx // per == i] % per]
                         .float())
            i += 1
    return (torch.cat(parts) * scale).cpu()
