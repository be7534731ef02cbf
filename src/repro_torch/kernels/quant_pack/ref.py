"""Per-group int8 quantization, plain PyTorch version.

The counterpart of the JAX package's ``kernels/quant_pack/ref.py``
(``quantize_ref``, ``dequantize_ref``) in the form its compiled code takes:
inside ``jit`` (and in the Pallas kernel ``kernels/quant_pack/kernel.py``)
XLA rewrites the scale's ``/ 127.0`` into a multiply by the float32
reciprocal, so the scale here is ``max(absmax, 1e-30) * float32(1/127)``.
The codes divide by the scale (an IEEE division) and round half to even.
The reference's eager ``quantize_ref`` divides instead, and differs from
this in the last bit of some scales.

The CPU tests run this, ``ops.py`` takes it for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernels (``kernel.py``) against it on the
card, bitwise.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["GROUP", "quantize_ref", "dequantize_ref"]

GROUP = 128


def _inv127(device) -> torch.Tensor:
    return torch.tensor(1.0 / 127.0, dtype=torch.float32, device=device)


def quantize_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [R, C] float32 or bfloat16 (C % 128 == 0) -> (q int8 [R, C],
    scales float32 [R, C / 128])."""
    r, c = x.shape
    g = x.to(torch.float32).reshape(r, c // GROUP, GROUP)
    absmax = g.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(1e-30) * _inv127(x.device)
    q = torch.round(g / scale).clamp_(-127, 127).to(torch.int8)
    return q.reshape(r, c), scale[..., 0]


def dequantize_ref(q: torch.Tensor, s: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q int8 [R, C], s float32 [R, C / 128] -> q * s as ``out_dtype``."""
    r, c = q.shape
    g = q.to(torch.float32).reshape(r, c // GROUP, GROUP)
    return (g * s[..., None]).reshape(r, c).to(out_dtype)
