"""Binding of the hand-written attention kernel (``csrc/flash_attention.cu``).

Replaces the JAX package's Pallas kernel
``kernels/flash_attention/kernel.py`` ``flash_attention_bhsd``, at the call
site of its XLA twin ``models/attention.py`` ``blockwise_attention``.  Two
paths, bound by operations (see the note at the top of the CUDA source):
bfloat16 with D 64/128 on ``wgmma`` with TMA loads, 192 (D 64) or 128
(D 128) query rows per block and ``KEY_TILE`` keys per tile, its first
block's rows on the FMA pipes at the same key tile (so that rows which see
few keys round P as the plain version does); float32, and D 32, on the
float32 FMA pipes, 64 query rows and 64 keys per tile.  ``plan`` says
which path a call takes.

Contract: ``flash_attention(q, k, v, causal=, window=)`` for q
[B, Hq, S, D] and k/v [B, Hkv, T, D] (float32 or bfloat16, contiguous, on
one CUDA device; D in 32, 64, 128; Hq a multiple of Hkv) gives
[B, Hq, S, D] in q's dtype, equal to ``ref.blockwise_ref`` up to float32
summation order, with P rounded at the path's key tiles.  Each input must
start on a 16-byte boundary.  ``LAUNCHES`` counts the launches of this
process, ``LAUNCHES_WGMMA`` those that the library reports it launched on
the ``wgmma`` path.

``flash_attention_bwd(q, k, v, o, do, causal=, window=)`` launches the
gradient kernel (``csrc/flash_attention_bwd.cu``, which replaces no Pallas
kernel: the reference takes this gradient by autodiff of
``blockwise_attention``) for the same forms with S = T, giving (dq, dk,
dv) in q's dtype, equal to autograd of ``ref.blockwise_ref`` up to float32
summation order (and, in bfloat16, the rounding of P before P.V, which
that autograd passes straight through).  ``BWD_LAUNCHES`` counts its calls
(three launches each: the pre-pass, dK/dV, dQ).  Both bindings raise when
grad mode is on and an input requires a gradient: ``ops.FlashAttentionFn``
is the differentiable op.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import check_launch, check_no_grad, check_tensor, library

__all__ = ["LAUNCHES", "LAUNCHES_WGMMA", "BWD_LAUNCHES", "HEAD_DIMS", "KEY_TILE",
           "flash_attention", "flash_attention_bwd", "plan", "wgmma_smem"]

#: kernel launches since the counter was last reset (``chip_smoke.py`` sets
#: it to 0 before the main path and reads it after), and those of them on
#: the ``wgmma`` path, as the library's entry reports it
LAUNCHES = 0
LAUNCHES_WGMMA = 0
#: calls of the gradient kernel (three launches each)
BWD_LAUNCHES = 0
HEAD_DIMS = (32, 64, 128)
#: keys per tile of the bfloat16 ``wgmma`` path: P is rounded to bfloat16
#: against the running max at these tiles, so the plain version
#: (``ref.blockwise_ref``) rounds as the kernel does at ``block_k=KEY_TILE``
KEY_TILE = 128
#: the ``wgmma`` path as ``csrc/flash_attention.cu`` (``wg::Cfg64``,
#: ``wg::Cfg128``) sets it: head dim -> (consumer warpgroups of 64 query
#: rows, beside one producer warpgroup; stages of the K/V ring)
_WGMMA = {64: (3, 3), 128: (2, 2)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def plan(dtype: torch.dtype, d: int, s: int) -> dict:
    """How the kernel runs ``q`` [.., S, D] of ``dtype``: its path (``"wgmma"`` or ``"fma"``), query rows per block,
    keys per tile, threads per block, dynamic shared memory in bytes, and
    blocks per head; on the ``wgmma`` path also ``fma_rows``, the leading
    query rows (the first block's) that run on the FMA pipes at the same
    key tile (where S is no more than those, the call is all FMA)."""
    if dtype == torch.bfloat16 and d in _WGMMA:
        nwg, stages = _WGMMA[d]
        block_q = 64 * nwg
        # 1,024 bytes to align the swizzled tiles, Q, the K/V ring, mbarriers
        smem = (1024 + block_q * d * 2 + stages * 2 * KEY_TILE * d * 2
                + 8 * (2 * stages + 1))
        return {"path": "wgmma" if s > block_q else "fma", "block_q": block_q,
                "key_tile": KEY_TILE, "threads": 128 * (nwg + 1), "stages": stages,
                "smem": smem, "blocks": -(-s // block_q), "fma_rows": min(s, block_q)}
    # float32 q^T, k^T (padded strides), v, and p^T (padded)
    smem = 4 * (d * 68 + d * 68 + 64 * d + 64 * 65)
    return {"path": "fma", "block_q": 64, "key_tile": 64, "threads": 256,
            "stages": 1, "smem": smem, "blocks": -(-s // 64)}


def _lib():
    lib = library("flash_attention")
    if not getattr(lib, "_spac_typed", False):
        for sfx in _SUFFIX.values():
            fn = getattr(lib, "flash_attention_" + sfx)
            fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           ctypes.c_float, _I, _I, _P, ctypes.POINTER(_I)]
            fn.restype = ctypes.c_int
        lib.flash_attention_wgmma_smem.argtypes = [_I]
        lib.flash_attention_wgmma_smem.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def wgmma_smem(d: int) -> int:
    """The ``wgmma`` path's dynamic shared memory at head dim ``d`` as the
    built kernel sets it (builds the library; ``plan`` must agree)."""
    return int(_lib().flash_attention_wgmma_smem(d))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the kernel on ``q``'s CUDA device."""
    global LAUNCHES, LAUNCHES_WGMMA
    check_no_grad("flash_attention", q, k, v)
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
    wgmma = _I(0)                       # the path the library launched
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
                  hkv, s, t, d, 1.0 / (d ** 0.5), int(causal), int(window), stream,
                  ctypes.byref(wgmma))
    check_launch(code, "flash_attention")
    LAUNCHES += 1
    LAUNCHES_WGMMA += wgmma.value
    return o


def _lib_bwd():
    lib = library("flash_attention_bwd")
    if not getattr(lib, "_spac_typed", False):
        for sfx in _SUFFIX.values():
            fn = getattr(lib, "flash_attention_bwd_" + sfx)
            fn.argtypes = [_P] * 9 + [_I] * 6 + [ctypes.c_float, _I, _I, _P]
            fn.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """Launch the gradient kernel on ``q``'s CUDA device: (dq, dk, dv) of
    ``flash_attention(q, k, v)`` = ``o`` for the incoming gradient ``do``."""
    global BWD_LAUNCHES
    check_no_grad("flash_attention_bwd", q, k, v, o, do)
    if q.device.type != "cuda":
        raise ValueError(f"q is on {q.device}: the attention gradient kernel takes "
                         "CUDA tensors (the plain version is autograd of "
                         "ref.blockwise_ref)")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be [B, Hq, S, D] and k/v [B, Hkv, T, D]")
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if q.dtype not in _SUFFIX:
        raise ValueError(f"q has dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} KV heads")
    if s != t:
        raise ValueError(f"S = {s} and T = {t}: the gradient kernel takes S = T")
    for name, x, shape in (("q", q, (b, hq, s, d)), ("k", k, (b, hkv, t, d)),
                           ("v", v, (b, hkv, t, d)), ("o", o, (b, hq, s, d)),
                           ("do", do, (b, hq, s, d))):
        check_tensor(x, name, q.dtype, shape, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    scratch = torch.empty((2, b * hq * s), dtype=torch.float32, device=q.device)
    fn = getattr(_lib_bwd(), "flash_attention_bwd_" + _SUFFIX[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), b, hq,
                  hkv, s, t, d, 1.0 / (d ** 0.5), int(causal), int(window), stream)
    check_launch(code, "flash_attention_bwd")
    BWD_LAUNCHES += 1
    return dq, dk, dv
