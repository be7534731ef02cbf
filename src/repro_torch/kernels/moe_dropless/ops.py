"""Public ops of the dropless expert layer's row moves: ``dispatch`` (the
tokens into the buffer of pairs sorted by expert) and ``combine`` (the
buffer's outputs, weighted by the gates, back to token order).

Device policy: CUDA tensors launch the hand-written kernels through
``DispatchFn`` and ``CombineFn``, which touch the rows before ``count``
alone, in both directions; CPU and meta tensors take the plain versions
(``ref.py``), which autograd differentiates as they are
(``build.takes_plain``).  Rows at and past ``count`` of what the kernels
return are left unwritten: the grouped products never read them, and the
other kernel of the pair never reads theirs.
"""

from __future__ import annotations

import torch

from ..build import takes_plain
from . import kernel
from .ref import combine_ref, dispatch_ref

__all__ = ["DispatchFn", "CombineFn", "dispatch", "combine"]


class DispatchFn(torch.autograd.Function):
    """xs [T, d] -> the buffer [T·k, d] on the card; the gradient of xs is
    each token's rows summed."""

    @staticmethod
    def forward(ctx, xs, tok, pos, count):
        ctx.save_for_backward(pos, count)
        return kernel.gather(xs, tok, count, tok.numel())

    @staticmethod
    def backward(ctx, drows):
        pos, count = ctx.saved_tensors
        return kernel.token_sum(drows.contiguous(), pos, count), None, None, None


class CombineFn(torch.autograd.Function):
    """(the buffer's outputs [T·k, d], gates [T, k]) -> [T, d] on the card;
    the gradient of a row is its token's times its gate, of a gate the dot
    of its token's gradient with its row."""

    @staticmethod
    def forward(ctx, y_rows, gates, tok, order, pos, count):
        ctx.save_for_backward(y_rows, gates, tok, order, pos, count)
        return kernel.token_sum(y_rows, pos, count, gates)

    @staticmethod
    def backward(ctx, dout):
        y_rows, gates, tok, order, pos, count = ctx.saved_tensors
        dout = dout.contiguous()
        g_rows = gates.reshape(-1).index_select(0, order)
        dy = kernel.gather(dout, tok, count, tok.numel(), g_rows)
        return dy, kernel.pair_dot(dout, y_rows, pos, count), None, None, None, None


def dispatch(xs: torch.Tensor, order: torch.Tensor, pos: torch.Tensor,
             count: torch.Tensor) -> torch.Tensor:
    """xs [T, d] -> [T·k, d]: row r the token of pair ``order[r]`` for r <
    ``count`` (the plain version zero past it)."""
    if takes_plain(xs):
        return dispatch_ref(xs, order, pos, count)
    return DispatchFn.apply(xs.contiguous(), order // pos.shape[1], pos.contiguous(), count)


def combine(y_rows: torch.Tensor, gates: torch.Tensor, order: torch.Tensor, pos: torch.Tensor,
            count: torch.Tensor) -> torch.Tensor:
    """[T·k, d] and gates [T, k] float32 -> [T, d] in y_rows' dtype: each
    token's sum over its pairs before ``count`` of gate · row, in float32."""
    if takes_plain(y_rows):
        return combine_ref(y_rows, gates, order, pos, count)
    return CombineFn.apply(y_rows.contiguous(), gates.contiguous(),
                           order // pos.shape[1], order, pos.contiguous(), count)
