"""Named spans of the training step, for ``torch.profiler``.

``span(name)`` marks a stretch of host code.  While a profiler records, it
is ``torch.profiler.record_function(name)``: the span lands in the same
trace as the device operations, on the profiler's clock, so a reader of the
trace can charge each kernel (through its launch) and each idle gap to the
span it fell in.  While none records, it costs one flag check and returns a
shared null context, with no ``record_function`` object and no dispatcher
call.

The spans of one step, each opened where its name says:

  ``STEP``       the step ``train.make_train_step`` returns: its whole body
  ``FORWARD``    ``value_and_grad``: the loss's forward (once a microbatch)
  ``BACKWARD``   ``value_and_grad``: ``torch.autograd.grad`` (once a microbatch)
  ``BLOCK``      ``models.transformer``: one layer's block in the forward
  ``RECOMPUTE``  the same block run again inside the backward (remat)
  ``LOSS``       ``models.transformer.loss_fn``: final norm, unembedding and
                 the cross-entropy
  ``CLIP``, ``LR``, ``OPTIMIZER``
                 ``train_step``: ``clip_by_global_norm``, ``lr_schedule``
                 with the copy of the step number, ``opt.update``
  ``MOE_ROUTE``, ``MOE_EXPERTS``, ``MOE_SHARED``, ``MOE_COMBINE``
                 ``models.moe.apply_dropless``, inside a block: the router
                 and the sort of the pairs by expert, the held experts'
                 grouped products, the shared expert, the weighted sum back
                 to token order

The backward pass has no span of its own per layer: the profiler's
``evaluate_function`` events carry the sequence number and thread of the
forward operation that made each autograd node, which lies in a forward
span.
"""

from __future__ import annotations

import contextlib

import torch
import torch.profiler

__all__ = ["STEP", "FORWARD", "BACKWARD", "BLOCK", "RECOMPUTE", "LOSS", "CLIP", "LR",
           "OPTIMIZER", "MOE_ROUTE", "MOE_EXPERTS", "MOE_SHARED", "MOE_COMBINE", "NAMES",
           "span", "block_span"]

STEP = "repro_torch.train.step"
FORWARD = "repro_torch.train.forward"
BACKWARD = "repro_torch.train.backward"
BLOCK = "repro_torch.model.block"
RECOMPUTE = "repro_torch.model.block.recompute"
LOSS = "repro_torch.model.loss"
CLIP = "repro_torch.train.clip"
LR = "repro_torch.train.lr"
OPTIMIZER = "repro_torch.train.optimizer"
MOE_ROUTE = "repro_torch.model.moe.route"
MOE_EXPERTS = "repro_torch.model.moe.experts"
MOE_SHARED = "repro_torch.model.moe.shared"
MOE_COMBINE = "repro_torch.model.moe.combine"
NAMES = (STEP, FORWARD, BACKWARD, BLOCK, RECOMPUTE, LOSS, CLIP, LR, OPTIMIZER,
         MOE_ROUTE, MOE_EXPERTS, MOE_SHARED, MOE_COMBINE)

_NULL = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str):
    """A context that marks ``name`` in a recording profiler's trace."""
    if not _recording():
        return _NULL
    return torch.profiler.record_function(name)


def block_span():
    """``BLOCK``, or ``RECOMPUTE`` when the block runs inside a backward
    pass (``torch.utils.checkpoint`` recomputing it)."""
    if not _recording():
        return _NULL
    inside = torch._C._current_graph_task_id() != -1
    return torch.profiler.record_function(RECOMPUTE if inside else BLOCK)
