"""Public batch header-parsing op.

Device policy: ``words`` on a CUDA device launch the hand-written kernel
(``kernel.parse_words``); ``words`` on the CPU take the plain PyTorch
version (``ref.parse_ref``).  There is no fallback from one to the other.
The JAX package's lane padding (words to 128, rows to the block) has no
counterpart: the kernel masks its ragged edge itself.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.dsl import Protocol
from . import kernel
from .ref import bake_slices, parse_ref

__all__ = ["parse_headers"]


def parse_headers(protocol: Protocol, field_names: Sequence[str],
                  words: torch.Tensor) -> torch.Tensor:
    """[B, W] uint32 packed headers -> [B, len(field_names)] uint32 fields."""
    if words.device.type == "cpu":
        return parse_ref(protocol, field_names, words)
    table, first = kernel.slice_table(bake_slices(protocol, field_names),
                                      words.device)
    return kernel.parse_words(words.to(torch.uint32).contiguous(), table,
                              first, n_words=words.shape[1])
