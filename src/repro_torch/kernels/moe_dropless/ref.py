"""Plain PyTorch statements of the dropless expert layer's moves between
token order and the buffer of (token, expert) pairs sorted by expert
(``csrc/moe_dropless.cu``; ``models/moe.py`` ``apply_dropless``).

Row r of the buffer is pair ``order[r]`` (token ``order[r] // k``); the
held experts' rows come first and end at ``count`` (a one-element int
tensor on the device); ``pos`` [T, k] is the inverse of the sort, the row of
each token's j-th pair.  The plain versions work on every row and mask the
rows at and past ``count`` to zero, on the way in and on the way out, so
whatever the grouped products leave there adds nothing, forward or
backward; autograd differentiates them as they are.  They are the card
kernels' oracle and what the CPU runs.
"""

from __future__ import annotations

import torch

__all__ = ["dispatch_ref", "combine_ref", "token_sum_ref"]


def _valid(order: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    return (torch.arange(order.numel(), device=order.device) < count)[:, None]


def token_sum_ref(rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """[T, d] float32: each token's k rows summed in the order of its
    choices."""
    t, k = pos.shape
    return rows.index_select(0, pos.reshape(-1)).view(t, k, -1).sum(1, dtype=torch.float32)


def dispatch_ref(xs: torch.Tensor, order: torch.Tensor, pos: torch.Tensor,
                 count: torch.Tensor) -> torch.Tensor:
    """xs [T, d] -> the buffer [T·k, d]: row r the token of pair order[r],
    zero from ``count`` on."""
    return torch.where(_valid(order, count), xs.index_select(0, order // pos.shape[1]), 0.0)


def combine_ref(y_rows: torch.Tensor, gates: torch.Tensor, order: torch.Tensor,
                pos: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The buffer's outputs [T·k, d] and the gates [T, k] float32 -> [T, d]
    in y_rows' dtype: each token's sum over its pairs before ``count`` of
    gate · row, in float32."""
    g_rows = gates.reshape(-1).index_select(0, order)
    contrib = torch.where(_valid(order, count), y_rows, 0.0) * g_rows[:, None]
    return token_sum_ref(contrib, pos).to(y_rows.dtype)
