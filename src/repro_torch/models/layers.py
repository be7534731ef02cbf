"""Shared layers: norms, gated MLP, embeddings — functional, dict params.

The port's counterpart of the JAX package's ``models/layers.py``.  Every
``init_*`` returns the parameters only: the reference also returns
``PartitionSpec`` trees, and the port runs on one device, where there is
nothing to shard.

The JAX package draws from ``jax.random`` keys; the port draws from an
explicit ``torch.Generator``, on the generator's device.  The two give
different numbers for the same seed, so parity runs carry one set of
weights to both (``repro_torch.convert.seeded_model_arrays`` and
``model_params``).

``matmul`` is the reference's ``jnp.einsum`` on mixed dtypes: both operands
are promoted to the wider type first, so float32 activations against
bfloat16 weights multiply in float32, as in JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from .config import ModelConfig, ShardingPlan

__all__ = ["rms_norm", "init_embedding", "init_unembed", "init_mlp", "apply_mlp",
           "init_norm", "dense_init", "matmul"]


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


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two (``jnp.einsum``'s rule)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.to(torch.float32)).to(x.dtype)


def init_norm(cfg: ModelConfig, device=None) -> torch.Tensor:
    return torch.ones((cfg.d_model,), dtype=torch.float32, device=device)


def init_embedding(gen: torch.Generator, cfg: ModelConfig,
                   plan: Optional[ShardingPlan] = None) -> torch.Tensor:
    del plan
    return dense_init(gen, (cfg.vocab, cfg.d_model), fan_in=cfg.d_model)


def init_unembed(gen: torch.Generator, cfg: ModelConfig,
                 plan: Optional[ShardingPlan] = None) -> torch.Tensor:
    del plan
    return dense_init(gen, (cfg.d_model, cfg.vocab))


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             plan: Optional[ShardingPlan] = None,
             d_ff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    del plan
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi": dense_init(gen, (d, ff)),
        "wg": dense_init(gen, (d, ff)),
        "wo": dense_init(gen, (ff, d), fan_in=ff),
    }


def apply_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    h = matmul(x, params["wi"])
    g = matmul(x, params["wg"])
    h = h * torch.nn.functional.silu(g.to(torch.float32)).to(h.dtype)
    return matmul(h, params["wo"])
