"""Binding of the hand-written attention kernel (``csrc/flash_attention.cu``).

Replaces the JAX package's Pallas kernel
``kernels/flash_attention/kernel.py`` ``flash_attention_bhsd``, at the call
site of its XLA twin ``models/attention.py`` ``blockwise_attention``.  One
block per 64-query tile: bfloat16 with D 64/128 on the tensor cores
(``mma.sync``), float32 and D 32 on the float32 FMA pipes; bound by
operations (see the note at the top of the CUDA source).

Contract: ``flash_attention(q, k, v, causal=, window=)`` for q
[B, Hq, S, D] and k/v [B, Hkv, T, D] (float32 or bfloat16, contiguous, on
one CUDA device; D in 32, 64, 128; Hq a multiple of Hkv) gives
[B, Hq, S, D] in q's dtype, equal to ``ref.blockwise_ref`` up to float32
summation order.  Each input must start on a 16-byte boundary.  ``LAUNCHES`` counts the launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import check_launch, check_tensor, library

__all__ = ["LAUNCHES", "HEAD_DIMS", "flash_attention"]

#: kernel launches since the counter was last reset (``chip_smoke.py`` sets
#: it to 0 before the main path and reads it after)
LAUNCHES = 0
HEAD_DIMS = (32, 64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _lib():
    lib = library("flash_attention")
    if not getattr(lib, "_spac_typed", False):
        for sfx in _SUFFIX.values():
            fn = getattr(lib, "flash_attention_" + sfx)
            fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           ctypes.c_float, _I, _I, _P]
            fn.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the kernel on ``q``'s CUDA device."""
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"q is on {q.device}: the attention kernel takes CUDA "
                         "tensors (the plain version is ref.blockwise_ref)")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be [B, Hq, S, D] and k/v [B, Hkv, T, D]")
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if q.dtype not in _SUFFIX:
        raise ValueError(f"q has dtype {q.dtype}; the kernel takes float32 or "
                         "bfloat16")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} KV heads")
    check_tensor(q, "q", q.dtype, (b, hq, s, d), q.device)
    check_tensor(k, "k", q.dtype, (b, hkv, t, d), q.device)
    check_tensor(v, "v", q.dtype, (b, hkv, t, d), q.device)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel "
                             "copies rows in 16-byte pieces)")
    o = torch.empty_like(q)
    if o.numel() == 0 or t == 0:
        return o
    fn = getattr(_lib(), "flash_attention_" + _SUFFIX[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
                  hkv, s, t, d, 1.0 / (d ** 0.5), int(causal), int(window), stream)
    check_launch(code, "flash_attention")
    LAUNCHES += 1
    return o
