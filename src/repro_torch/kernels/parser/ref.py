"""Header-field extraction, plain PyTorch version.

The counterpart of the JAX package's ``kernels/parser/ref.py`` (``parse_ref``)
and ``kernels/parser/kernel.py`` (``bake_slices``): the protocol's parser
plan is lowered once to per-field pieces ``(word, lo, take, dst_shift)``,
and each field is the OR of its shifted, masked word pieces.  PyTorch has no
``>>`` on ``uint32``, so the arithmetic runs in int64 on values masked to 32
bits; the result is cast back to ``uint32``, equal bit for bit to the
reference's uint32 sequence.

The CPU tests run this, ``switch/parser.make_field_extractor`` is built on
it, and ``chip_smoke.py`` holds the CUDA kernel (``kernel.py``) against it
on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.dsl import Protocol

__all__ = ["WORD_BITS", "bake_slices", "extract_fields", "parse_ref"]

WORD_BITS = 32
_U32 = 0xFFFFFFFF

Baked = Tuple[Tuple[Tuple[int, int, int, int], ...], ...]


def bake_slices(protocol: Protocol, field_names: Sequence[str]) -> Baked:
    """Compile-time lowering: field -> ((word, lo, width, dst_shift), ...)."""
    plan = protocol.compile(WORD_BITS)
    baked = []
    for name in field_names:
        pieces = []
        for s in plan.slices_for(name):
            take = s.hi - s.lo + 1
            if s.dst_shift >= WORD_BITS:
                continue  # truncated to low 32 bits (lookup keys are <=32b)
            pieces.append((s.word, s.lo, take, s.dst_shift))
        baked.append(tuple(pieces))
    return tuple(baked)


def extract_fields(baked: Baked, words: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """uint32 (or int64 holding uint32) words [..., W] -> one int64 tensor
    per field, each value in [0, 2**32)."""
    w = words.to(torch.int64) & _U32
    outs = []
    for pieces in baked:
        v = torch.zeros(w.shape[:-1], dtype=torch.int64, device=w.device)
        for word, lo, take, dst_shift in pieces:
            piece = (w[..., word] >> lo) & ((1 << take) - 1)
            v = v | ((piece << dst_shift) & _U32)
        outs.append(v)
    return tuple(outs)


def parse_ref(protocol: Protocol, field_names: Sequence[str],
              words: torch.Tensor) -> torch.Tensor:
    """[B, W] uint32 packed headers -> [B, len(field_names)] uint32 fields."""
    cols = extract_fields(bake_slices(protocol, field_names), words)
    if not cols:
        return torch.zeros((words.shape[0], 0), dtype=torch.uint32,
                           device=words.device)
    return torch.stack(cols, dim=1).to(torch.uint32)
