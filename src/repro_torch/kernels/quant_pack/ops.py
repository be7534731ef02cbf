"""Public ops for payload compression (int8 codes + one float32 scale per
128-element group): the dispatch fabric's wire format.

Device policy: CUDA tensors launch the hand-written kernels
(``kernel.quantize``/``kernel.dequantize``), CPU tensors take the plain
PyTorch versions (``ref.py``); there is no fallback from one to the other.
``compress``/``decompress`` round-trip a tensor of any shape by flattening
it to [R, 128] (zero-padded), as the JAX package's ``ops.py`` does.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import kernel
from .ref import GROUP, dequantize_ref, quantize_ref

__all__ = ["GROUP", "quantize", "dequantize", "compress", "decompress",
           "compression_ratio"]


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [R, C] (C % 128 == 0) -> (q int8 [R, C], scales float32 [R, C/128])."""
    if x.device.type == "cpu":
        return quantize_ref(x)
    return kernel.quantize(x.contiguous())


def dequantize(q: torch.Tensor, s: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(q, s) -> [R, C] ``out_dtype``."""
    if q.device.type == "cpu":
        return dequantize_ref(q, s, out_dtype)
    return kernel.dequantize(q.contiguous(), s.contiguous(), out_dtype)


def _to_2d(x: torch.Tensor):
    shape = tuple(x.shape)
    flat = math.prod(shape)
    v = torch.nn.functional.pad(x.reshape(-1), (0, (-flat) % GROUP))
    return v.reshape(-1, GROUP), (shape, flat)


def compress(x: torch.Tensor):
    """tensor -> (q int8 [R, 128], scales float32 [R, 1], meta): the wire format."""
    v, meta = _to_2d(x)
    q, s = quantize(v)
    return q, s, meta


def decompress(q: torch.Tensor, s: torch.Tensor, meta, *,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    shape, flat = meta
    return dequantize(q, s, dtype).reshape(-1)[:flat].reshape(shape)


def compression_ratio(x: torch.Tensor) -> float:
    """Wire-bytes ratio vs the uncompressed dtype (the 'header compression' win)."""
    in_bytes = x.numel() * x.element_size()
    out_bytes = x.numel() * 1 + (x.numel() // GROUP) * 4
    return in_bytes / out_bytes
