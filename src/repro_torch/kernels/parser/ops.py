"""Public batch header-parsing op.

Device policy: ``words`` on a CUDA device launch the hand-written kernel
(``kernel.parse_words``); ``words`` on the CPU take the plain PyTorch
version (``ref.parse_ref``).  There is no fallback from one to the other.
The JAX package's lane padding (words to 128, rows to the block) has no
counterpart: the kernel masks its ragged edge itself.

A protocol's baked slices and the kernel's packed table are made once per
protocol layout (``core.dsl.layout_key``) and field list (``slices``), as
the reference bakes them into its kernel once at trace time.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.dsl import LayoutKey, Protocol, layout_key
from . import kernel
from .ref import Baked, bake_slices, parse_ref

__all__ = ["Slices", "parse_headers", "slices"]


class Slices(NamedTuple):
    baked: Baked          # bake_slices(protocol, fields)
    table: kernel.Table   # the same, as the kernel's parameter


_SLICES: Dict[Tuple[LayoutKey, Tuple[str, ...]], Slices] = {}


def slices(protocol: Protocol, field_names: Sequence[str]) -> Slices:
    """The fields' baked slices and packed table, made on the first call for
    this layout and these fields."""
    key = (layout_key(protocol), tuple(field_names))
    got = _SLICES.get(key)
    if got is None:
        baked = bake_slices(protocol, field_names)
        got = _SLICES[key] = Slices(baked, kernel.pack_table(baked))
    return got


def parse_headers(protocol: Protocol, field_names: Sequence[str],
                  words: torch.Tensor) -> torch.Tensor:
    """[B, W] uint32 packed headers -> [B, len(field_names)] uint32 fields."""
    if words.device.type == "cpu":
        return parse_ref(protocol, field_names, words)
    if words.dtype != torch.uint32 or not words.is_contiguous():
        words = words.to(torch.uint32).contiguous()
    return kernel.parse_words(words, slices(protocol, field_names).table)
