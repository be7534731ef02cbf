"""Public attention op over [B, H, S, D] with GQA.

Device policy: CUDA tensors launch the hand-written kernel
(``kernel.flash_attention``) through ``FlashAttentionFn``, whose backward
launches the hand-written gradient kernel (``kernel.flash_attention_bwd``);
CPU and meta tensors take the plain PyTorch version (``ref.blockwise_ref``),
which autograd differentiates as it is (``build.takes_plain``; any other
device raises).  There is no fallback from one to the other.
``attention_reference`` is the port of the JAX package's oracle op (heads
repeated, exact softmax).
"""

from __future__ import annotations

import torch

from ..build import takes_plain
from . import kernel
from .ref import attention_ref, blockwise_ref

__all__ = ["FlashAttentionFn", "flash_attention", "attention_reference"]


class FlashAttentionFn(torch.autograd.Function):
    """Attention on the card with its gradient: the forward kernel, which
    also writes each row's log-sum-exp, and the gradient kernel from the
    saved q, k, v, output and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        b, hq, s, _ = q.shape
        lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
        o = kernel.flash_attention(q, k, v, causal=causal, window=window, lse=lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = kernel.flash_attention_bwd(q, k, v, o, _aligned(do.to(q.dtype)),
                                                causal=ctx.causal, window=ctx.window,
                                                lse=lse)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, block_q: int = 512,
                    block_k: int = 1024) -> torch.Tensor:
    """q [B, Hq, S, D], k/v [B, Hkv, T, D] -> [B, Hq, S, D].  ``block_q`` and
    ``block_k`` tile the plain version only: the kernel picks its own."""
    if takes_plain(q):
        return blockwise_ref(q, k, v, causal=causal, window=window,
                             block_q=block_q, block_k=block_k)
    return FlashAttentionFn.apply(_aligned(q), _aligned(k), _aligned(v), causal, window)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and starting on a 16-byte boundary (a view into the
    middle of a tensor may not)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def attention_reference(q, k, v, *, causal: bool = True) -> torch.Tensor:
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hkv != hq:
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    out = attention_ref(q.reshape(b * hq, s, d), k.reshape(b * hq, -1, d),
                        v.reshape(b * hq, -1, d), causal=causal)
    return out.reshape(b, hq, s, d)
