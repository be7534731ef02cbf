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

``flash_attention(..., lse=buf)`` also writes each row's log-sum-exp of
its scaled scores into ``buf`` (float32 [B, Hq, S]); ``o`` is the same
with or without it.  The plain counterpart is ``ref.blockwise_ref(...,
return_lse=True)``.

``flash_attention_bwd(q, k, v, o, do, causal=, window=, lse=)`` launches
the gradient kernel (``csrc/flash_attention_bwd.cu``, which replaces no
Pallas kernel: the reference takes this gradient by autodiff of
``blockwise_attention``) for the same forms with S = T, giving (dq, dk,
dv) in q's dtype, equal to autograd of ``ref.blockwise_ref`` within
``chip_smoke.FLASH_BWD_TOL``.  It takes the forward's ``lse``; without
one it launches the forward kernel once more to write it.  Three
launches a call: a pre-pass (D = do.o, bytes-bound), the dK/dV pass and
the dQ pass.  ``plan_bwd`` says which path a call takes, as ``plan``
does for the forward: bfloat16 with D 64/128 on ``wgmma`` (P and dS
rounded to bfloat16 as product operands), float32 and D 32 on the FMA
pipes.  ``BWD_LAUNCHES`` counts its calls, ``BWD_LAUNCHES_WGMMA`` those
that the library reports it ran on ``wgmma``.  Both bindings raise when
grad mode is on and an input requires a gradient: ``ops.FlashAttentionFn``
is the differentiable op.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import check_launch, check_no_grad, check_tensor, library

__all__ = ["LAUNCHES", "LAUNCHES_WGMMA", "BWD_LAUNCHES", "BWD_LAUNCHES_WGMMA",
           "HEAD_DIMS", "KEY_TILE", "flash_attention", "flash_attention_bwd",
           "bwd_passes", "plan", "plan_bwd", "wgmma_smem", "bwd_wgmma_smem"]

#: kernel launches since the counter was last reset (``chip_smoke.py`` sets
#: it to 0 before the main path and reads it after), and those of them on
#: the ``wgmma`` path, as the library's entry reports it
LAUNCHES = 0
LAUNCHES_WGMMA = 0
#: calls of the gradient kernel (three launches each), and those of them on
#: the ``wgmma`` passes, as the library's entry reports it
BWD_LAUNCHES = 0
BWD_LAUNCHES_WGMMA = 0
HEAD_DIMS = (32, 64, 128)
#: keys per tile of the bfloat16 ``wgmma`` path: P is rounded to bfloat16
#: against the running max at these tiles, so the plain version
#: (``ref.blockwise_ref``) rounds as the kernel does at ``block_k=KEY_TILE``
KEY_TILE = 128
#: the ``wgmma`` path as ``csrc/flash_attention.cu`` (``wg::Cfg64``,
#: ``wg::Cfg128``) sets it: head dim -> (consumer warpgroups of 64 query
#: rows, beside one producer warpgroup; stages of the K/V ring)
_WGMMA = {64: (3, 3), 128: (2, 2)}
#: the gradient's ``wgmma`` passes as ``csrc/flash_attention_bwd.cu``
#: (``wg::Bwd64``, ``wg::Bwd128``) sets them: head dim -> stages of the ring
#: (two consumer warpgroups of 64 rows beside one producer warpgroup, 64-row
#: streamed tiles)
_BWD_WGMMA = {64: 4, 128: 3}
#: the gradient's lse2 and D rows per head are padded to a multiple of this
LSE_ALIGN = 128

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


def plan_bwd(dtype: torch.dtype, d: int, s: int) -> dict:
    """How the gradient kernel runs ``q`` [.., S, D] of ``dtype`` (S = T):
    its path (``"wgmma"`` for bfloat16 at D 64/128, else ``"fma"``), rows
    per block of each pass (keys in the dK/dV pass, query rows in the dQ
    pass), rows per streamed tile, threads and dynamic shared memory of
    each pass, blocks per KV head (``kv_blocks``) and per query head
    (``q_blocks``), and the padded rows of lse2/D per head (``pitch``)."""
    pitch = -(-s // LSE_ALIGN) * LSE_ALIGN
    if dtype == torch.bfloat16 and d in _BWD_WGMMA:
        stages = _BWD_WGMMA[d]
        tile = 64 * d * 2                      # 64 rows x D in bf16
        # 1,024 bytes to align the swizzled tiles, two resident operands of
        # two warpgroups, the ring (two tiles and 64 lse2 + 64 D a stage),
        # mbarriers
        smem = 1024 + 2 * 2 * tile + stages * (2 * tile + 512) + 8 * (2 * stages + 1)
        return {"path": "wgmma", "block": 128, "tile": 64, "threads": 384,
                "stages": stages, "smem": smem, "smem_kv": smem, "smem_q": smem,
                "kv_blocks": -(-s // 128), "q_blocks": -(-s // 128), "pitch": pitch}
    # float32 tiles transposed at pitch 65: k, v, q, do and p, ds (dK/dV);
    # q, do, k, v and ds (dQ); 64 lse2 and 64 D each
    smem_kv = 4 * (4 * d * 65 + 2 * 64 * 65 + 128)
    smem_q = 4 * (4 * d * 65 + 64 * 65 + 128)
    return {"path": "fma", "block": 64, "tile": 64, "threads": 256, "stages": 1,
            "smem": max(smem_kv, smem_q), "smem_kv": smem_kv, "smem_q": smem_q,
            "kv_blocks": -(-s // 64), "q_blocks": -(-s // 64), "pitch": pitch}


def _lib():
    lib = library("flash_attention")
    if not getattr(lib, "_spac_typed", False):
        for sfx in _SUFFIX.values():
            fn = getattr(lib, "flash_attention_" + sfx)
            fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
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
                    causal: bool = True, window: int = 0,
                    lse: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on ``q``'s CUDA device; with ``lse`` (float32
    [B, Hq, S]) it also writes each row's log-sum-exp there."""
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
    if lse is not None:
        check_tensor(lse, "lse", torch.float32, (b, hq, s), q.device)
    o = torch.empty_like(q)
    if o.numel() == 0 or t == 0:
        return o
    fn = getattr(_lib(), "flash_attention_" + _SUFFIX[q.dtype])
    wgmma = _I(0)                       # the path the library launched
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  None if lse is None else lse.data_ptr(), b, hq, hkv, s, t, d,
                  1.0 / (d ** 0.5), int(causal), int(window), stream,
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
            fn.argtypes = ([_P] * 10 + [_I] * 6 + [ctypes.c_float] + [_I] * 4
                           + [_P, ctypes.POINTER(_I)])
            fn.restype = ctypes.c_int
        lib.flash_attention_bwd_wgmma_smem.argtypes = [_I]
        lib.flash_attention_bwd_wgmma_smem.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def bwd_wgmma_smem(d: int) -> int:
    """The gradient's ``wgmma`` passes' dynamic shared memory at head dim
    ``d`` as the built kernel sets it (builds the library; ``plan_bwd``
    must agree)."""
    return int(_lib_bwd().flash_attention_bwd_wgmma_smem(d))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, lse: torch.Tensor | None = None):
    """Launch the gradient kernel on ``q``'s CUDA device: (dq, dk, dv) of
    ``flash_attention(q, k, v)`` = ``o`` for the incoming gradient ``do``,
    from the forward's log-sum-exp ``lse`` (float32 [B, Hq, S]; without it
    the forward kernel is launched once more to write it)."""
    return bwd_passes(q, k, v, o, do, causal=causal, window=window, lse=lse)


def bwd_passes(q, k, v, o, do, *, causal: bool = True, window: int = 0, lse=None,
               passes: int = 7, scratch: torch.Tensor | None = None):
    """``flash_attention_bwd``'s launches, or some of them alone (``passes``:
    1 the pre-pass, 2 the dK/dV pass, 4 the dQ pass; 7 the gradient) on
    ``scratch`` (float32 [2, B·Hq·pitch], ``plan_bwd``'s pitch: lse2 and D,
    which the pre-pass writes and the other two read), for timing one launch
    alone.  Returns (dq, dk, dv); only the outputs of the passes run are
    written."""
    global BWD_LAUNCHES, BWD_LAUNCHES_WGMMA
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
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel "
                             "reads rows in 16-byte pieces)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    if lse is None:
        lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
        flash_attention(q, k, v, causal=causal, window=window, lse=lse)
    check_tensor(lse, "lse", torch.float32, (b, hq, s), q.device)
    pitch = plan_bwd(q.dtype, d, s)["pitch"]
    if scratch is None:
        scratch = torch.empty((2, b * hq * pitch), dtype=torch.float32, device=q.device)
    check_tensor(scratch, "scratch", torch.float32, (2, b * hq * pitch), q.device)
    fn = getattr(_lib_bwd(), "flash_attention_bwd_" + _SUFFIX[q.dtype])
    wgmma = _I(0)                       # the path the library launched
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  scratch.data_ptr(), b, hq, hkv, s, t, d, 1.0 / (d ** 0.5), int(causal),
                  int(window), pitch, int(passes), stream, ctypes.byref(wgmma))
    check_launch(code, "flash_attention_bwd")
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_WGMMA += wgmma.value
    return dq, dk, dv
