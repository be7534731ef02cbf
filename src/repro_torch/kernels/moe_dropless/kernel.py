"""Binding of the dropless expert layer's row moves (``csrc/moe_dropless.cu``).

Replaces no Pallas kernel: the JAX package has no dropless layer.  Three
functions, each bound by bytes, each reading ``count`` (the held experts'
last offset, int32 [1] on the device) and touching the pairs before it
alone (the note at the top of the CUDA source):

- ``gather(src, idx, count, rows, scale=None)``: [rows, d] with row r <
  count ``src[idx[r]]`` (times ``scale[r]``, float32); the rest of the rows
  are left unwritten (``moe_gather``);
- ``token_sum(rows, pos, count, w=None)``: [T, d], each token's sum over its
  pairs before ``count`` of (``w[t, j]`` ·) ``rows[pos[t, j]]``, float32,
  one rounding (``moe_token_sum``);
- ``pair_dot(dout, rows, pos, count)``: float32 [T, k], the dot of each
  token's incoming gradient with the row of each of its pairs, 0 past
  ``count`` (``moe_pair_dot``).

Activations bfloat16 or float32, d a multiple of a 16-byte vector, k up to
16, every tensor contiguous on one CUDA device and on 16-byte boundaries,
checked here; a form the source does not take raises ``ValueError``.  One
counter a kernel: ``GATHER_LAUNCHES``, ``TOKEN_SUM_LAUNCHES``,
``PAIR_DOT_LAUNCHES``.  ``ops.DispatchFn`` and ``ops.CombineFn`` are the
differentiable ops.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..build import check_launch, check_no_grad, library

__all__ = ["GATHER_LAUNCHES", "TOKEN_SUM_LAUNCHES", "PAIR_DOT_LAUNCHES", "gather",
           "token_sum", "pair_dot"]

#: launches of each kernel since the counters were last reset
GATHER_LAUNCHES = 0
TOKEN_SUM_LAUNCHES = 0
PAIR_DOT_LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_REFUSED = -1


def _lib():
    lib = library("moe_dropless")
    if not getattr(lib, "_spac_typed", False):
        for sfx in _DTYPES.values():
            getattr(lib, "moe_gather_" + sfx).argtypes = [_P] * 5 + [_I] * 2 + [_P]
            getattr(lib, "moe_token_sum_" + sfx).argtypes = [_P] * 5 + [_I] * 3 + [_P]
            getattr(lib, "moe_pair_dot_" + sfx).argtypes = [_P] * 5 + [_I] * 3 + [_P]
            for kind in ("gather", "token_sum", "pair_dot"):
                getattr(lib, f"moe_{kind}_{sfx}").restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def _check(t: torch.Tensor, name: str, dtype, dim: int, dev) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-d tensor")
    if t.device != dev or t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the kernels take tensors on one CUDA device")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (vector loads)")


def _act(t: torch.Tensor, name: str) -> str:
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernels take float32 or bfloat16")
    return _DTYPES[t.dtype]


def _count(count: torch.Tensor, dev) -> None:
    if count.dtype != torch.int32 or count.numel() != 1 or count.device != dev:
        raise ValueError("count must be one int32 on the activations' device")


def _launched(code: int, what: str, **form) -> None:
    if code == _REFUSED:
        raise ValueError(f"{what} does not take {form}: d a multiple of a 16-byte vector, "
                         "k from 1 to 16")
    check_launch(code, what)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def gather(src: torch.Tensor, idx: torch.Tensor, count: torch.Tensor, rows: int,
           scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``moe_gather``: [rows, d] in src's dtype, rows < count written."""
    global GATHER_LAUNCHES
    check_no_grad("gather", *(t for t in (src, idx, count, scale) if t is not None))
    sfx, dev = _act(src, "src"), src.device
    _count(count, dev)
    _check(src, "src", src.dtype, 2, dev)
    _check(idx, "idx", torch.int64, 1, dev)
    if idx.numel() != rows or (scale is not None and scale.shape != (rows,)):
        raise ValueError(f"idx (and scale) must hold {rows} rows")
    if scale is not None:
        _check(scale, "scale", torch.float32, 1, dev)
    out = torch.empty((rows, src.shape[1]), dtype=src.dtype, device=dev)
    if rows and src.shape[1]:
        with torch.cuda.device(dev):
            code = getattr(_lib(), "moe_gather_" + sfx)(
                src.data_ptr(), idx.data_ptr(), None if scale is None else scale.data_ptr(),
                count.data_ptr(), out.data_ptr(), rows, src.shape[1], _stream(dev))
        _launched(code, "moe_gather", rows=rows, d=src.shape[1])
        GATHER_LAUNCHES += 1
    return out


def token_sum(rows: torch.Tensor, pos: torch.Tensor, count: torch.Tensor,
              w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``moe_token_sum``: [T, d] in rows' dtype."""
    global TOKEN_SUM_LAUNCHES
    check_no_grad("token_sum", *(t for t in (rows, pos, count, w) if t is not None))
    sfx, dev = _act(rows, "rows"), rows.device
    _count(count, dev)
    _check(rows, "rows", rows.dtype, 2, dev)
    _check(pos, "pos", torch.int64, 2, dev)
    if w is not None:
        _check(w, "w", torch.float32, 2, dev)
        if w.shape != pos.shape:
            raise ValueError(f"w has shape {tuple(w.shape)}, pos {tuple(pos.shape)}")
    t, k = pos.shape
    out = torch.empty((t, rows.shape[1]), dtype=rows.dtype, device=dev)
    if out.numel():
        with torch.cuda.device(dev):
            code = getattr(_lib(), "moe_token_sum_" + sfx)(
                rows.data_ptr(), pos.data_ptr(), None if w is None else w.data_ptr(),
                count.data_ptr(), out.data_ptr(), t, k, rows.shape[1], _stream(dev))
        _launched(code, "moe_token_sum", T=t, k=k, d=rows.shape[1])
        TOKEN_SUM_LAUNCHES += 1
    return out


def pair_dot(dout: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
             count: torch.Tensor) -> torch.Tensor:
    """Launch ``moe_pair_dot``: float32 [T, k]."""
    global PAIR_DOT_LAUNCHES
    check_no_grad("pair_dot", dout, rows, pos, count)
    sfx, dev = _act(rows, "rows"), rows.device
    _count(count, dev)
    _check(rows, "rows", rows.dtype, 2, dev)
    _check(dout, "dout", rows.dtype, 2, dev)
    _check(pos, "pos", torch.int64, 2, dev)
    t, k = pos.shape
    if dout.shape != (t, rows.shape[1]):
        raise ValueError(f"dout has shape {tuple(dout.shape)}, expected {(t, rows.shape[1])}")
    dg = torch.empty((t, k), dtype=torch.float32, device=dev)
    if dg.numel():
        with torch.cuda.device(dev):
            code = getattr(_lib(), "moe_pair_dot_" + sfx)(
                dout.data_ptr(), rows.data_ptr(), pos.data_ptr(), count.data_ptr(),
                dg.data_ptr(), t, k, rows.shape[1], _stream(dev))
        _launched(code, "moe_pair_dot", T=t, k=k, d=rows.shape[1])
        PAIR_DOT_LAUNCHES += 1
    return dg
