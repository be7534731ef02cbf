"""Protocol-aware parser (§III-B.1) — PyTorch functional model.

The SPAC parser is *template-driven*: protocol details are baked in at compile
time (no TCAM, no runtime config registers).  Here the ``ParserPlan`` produced
by ``Protocol.compile`` plays the role of the instantiated C++ template: every
field access lowers to hard-wired shifts/masks over 32-bit header words, with
extra pieces only for fields that straddle word boundaries.

``pack_header_words`` is the vectorised serialiser (the NetBlocks driver
role, host NumPy as in the reference); ``make_field_extractor`` returns an
extractor identical in contract to the hand-written CUDA parser in
``repro_torch.kernels.parser`` — it is that kernel's plain version.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dsl import Protocol
from repro_torch.kernels.parser.ref import bake_slices, extract_fields

__all__ = ["WORD_BITS", "n_header_words", "pack_header_words", "make_field_extractor"]

WORD_BITS = 32


def n_header_words(protocol: Protocol) -> int:
    return -(-protocol.header_bits // WORD_BITS)


def pack_header_words(protocol: Protocol, values: Dict[str, np.ndarray]) -> np.ndarray:
    """Vectorised bit-exact packing into uint32 words, MSB-first.

    values[name] is an int array [n]; fields absent default to Field.default.
    Returns uint32 [n, n_words].
    """
    plan = protocol.compile(WORD_BITS)
    n = len(next(iter(values.values())))
    words = np.zeros((n, n_header_words(protocol)), dtype=np.uint64)
    for f in protocol.fields:
        v = np.asarray(values.get(f.name, np.full(n, f.default)), dtype=np.uint64)
        for s in plan.slices_for(f.name):
            take = s.hi - s.lo + 1
            piece = (v >> np.uint64(s.dst_shift)) & np.uint64((1 << take) - 1)
            words[:, s.word] |= piece << np.uint64(s.lo)
    return words.astype(np.uint32)


def make_field_extractor(
    protocol: Protocol, field_names: Sequence[str]
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """Compile-time specialised extractor: uint32 words [..., W] -> one
    tensor of values per field (int64 holding the uint32 value: PyTorch has
    no shift on uint32).

    Fields wider than 32 bits are truncated to their low 32 bits (the switch
    uses addresses modulo table size, so this is lossless for lookups of
    addr_bits <= 32).
    """
    baked = bake_slices(protocol, field_names)

    def extract(words: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return extract_fields(baked, words)

    return extract
