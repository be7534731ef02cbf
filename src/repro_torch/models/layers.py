"""Shared layers.  Only ``dense_init`` is ported so far (the MoE layer's
initializer); norms, embeddings and the gated MLP come with the model
forward path (ROADMAP, slice 4).

The JAX package draws from ``jax.random`` keys; the port draws from an
explicit ``torch.Generator``, on the generator's device.  The two give
different numbers for the same seed, so parity runs carry the reference's
weights across (``repro_torch.convert``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = ["dense_init"]


def dense_init(gen: torch.Generator, shape: Sequence[int],
               fan_in: Optional[int] = None,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """N(0, 1/fan_in) weights drawn in float32 from ``gen``, cast to ``dtype``
    (fan_in defaults to ``shape[-2]``, as in the reference)."""
    shape = tuple(shape)
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) > 1 else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * std).to(dtype)
