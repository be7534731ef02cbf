"""Public SSD ops: the chunked scan and the one-token decode step.

Device policy for ``ssd_chunked``: CUDA tensors launch the hand-written
kernel (``kernel.ssd_scan``, which picks its own chunk) through
``SSDScanFn``, whose backward launches the hand-written gradient kernel
(``kernel.ssd_scan_bwd``); a call that asks for the final state (the
prefill's) launches the forward kernel alone, and raises where a gradient
would be needed.  CPU and meta tensors take the plain version
(``ref.ssd_chunked_ref`` at ``chunk``), which autograd differentiates as it
is (``build.takes_plain``; any other device raises).  There is no
fallback from one to the other.  B and C go to the kernel in their own
dtype where both are float32 or both bfloat16 (the bf16 model's are bf16,
exact in one bf16 pass), else as float32.

B and C may come per head ([BH, S, N], as in the reference) or per group of
heads ([G, S, N], G dividing BH, row g serving the BH/G consecutive heads of
group g): the model's B and C are shared by a sequence's heads, and the
reference's H-fold broadcast of them is a memory layout, not part of the
function.  The kernel reads the grouped form directly.
"""

from __future__ import annotations

import torch

from ..build import takes_plain
from . import kernel
from .ref import ssd_chunked_ref

__all__ = ["SSDScanFn", "ssd_chunked", "ssd_decode_step"]


class SSDScanFn(torch.autograd.Function):
    """The SSD scan on the card with its gradient (no final state): the
    forward kernel, and the gradient kernel from the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c):
        y = kernel.ssd_scan(x, dt, a, b, c)
        ctx.save_for_backward(x, dt, a, b, c)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, a, b, c = ctx.saved_tensors
        return kernel.ssd_scan_bwd(x, dt, a, b, c, _aligned(dy.to(x.dtype).contiguous()))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where it does not start on a 16-byte boundary
    (TMA reads x, the incoming gradient, B and C)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _per_head(t: torch.Tensor, bh: int) -> torch.Tensor:
    g = t.shape[0]
    return t if g == bh else torch.repeat_interleave(t, bh // g, dim=0)


def ssd_chunked(x, dt, a, b, c, *, chunk: int = 128, return_state: bool = False):
    """x [BH, S, P], dt [BH, S], a [BH], b/c [BH or G, S, N] -> y [BH, S, P]
    in x's dtype (and the final state [BH, P, N] float32)."""
    bh = x.shape[0]
    if b.shape[0] != c.shape[0] or bh % b.shape[0]:
        raise ValueError(f"b/c rows {b.shape[0]}, {c.shape[0]} must divide {bh}")
    if takes_plain(x):
        return ssd_chunked_ref(x, dt, a, _per_head(b, bh), _per_head(c, bh),
                               chunk=chunk, return_state=return_state)
    f32 = torch.float32
    if not (b.dtype == c.dtype and b.dtype in (f32, torch.bfloat16)):
        b, c = b.to(f32), c.to(f32)
    x, b, c = _aligned(x.contiguous()), _aligned(b.contiguous()), _aligned(c.contiguous())
    dt, a = dt.to(f32).contiguous(), a.to(f32).contiguous()
    if return_state:
        return kernel.ssd_scan(x, dt, a, b, c, return_state=True)
    return SSDScanFn.apply(x, dt, a, b, c)


def ssd_decode_step(state, x_t, dt_t, a, b_t, c_t):
    """Single-token recurrence for serving.  state [BH,P,N] -> (state, y [BH,P])."""
    decay = torch.exp(dt_t * a)[:, None, None]
    state = state * decay + dt_t[:, None, None] * torch.einsum("hp,hn->hpn", x_t, b_t)
    y = torch.einsum("hpn,hn->hp", state, c_t)
    return state, y
