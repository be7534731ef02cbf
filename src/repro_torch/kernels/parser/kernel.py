"""Binding of the hand-written header-parser kernel (``csrc/parser.cu``).

Replaces the JAX package's generated Pallas parser
``kernels/parser/kernel.py`` (``make_parser`` and its ``_kernel`` closure).
One thread per header; the protocol's baked slice table
``(field, word, lo, take, dst_shift)`` is a small int32 tensor the kernel
stages in shared memory, so one compiled kernel parses every protocol.
Bound by bytes (each header read once, each field written once); see the
note at the top of the CUDA source.

Contract: ``words`` [B, W] uint32 → ``[B, F]`` uint32 fields, bitwise equal
to ``ref.parse_ref``.  ``LAUNCHES`` counts the kernel launches of this
process.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import check_launch, check_tensor, library
from .ref import Baked

__all__ = ["LAUNCHES", "parse_words", "slice_table"]

#: kernel launches since the counter was last reset (``chip_smoke.py`` sets
#: it to 0 before the main path and reads it after)
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = library("parser")
    if not getattr(lib, "_spac_typed", False):
        lib.parse_headers_u32.argtypes = [_P, _P, _P, _P, ctypes.c_longlong,
                                          _I, _I, _I, _P]
        lib.parse_headers_u32.restype = ctypes.c_int
        lib.parser_max_pieces.argtypes = []
        lib.parser_max_pieces.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def slice_table(baked: Baked, device) -> tuple:
    """The baked slices as the kernel's int32 tables: pieces [P, 5] rows
    (field, word, lo, take, dst_shift) and per-field offsets [F + 1]."""
    rows, first = [], [0]
    for f, pieces in enumerate(baked):
        rows.extend((f, *p) for p in pieces)
        first.append(len(rows))
    table = torch.tensor(rows or [[0] * 5], dtype=torch.int32).reshape(-1, 5)
    return (table[:len(rows)].contiguous().to(device),
            torch.tensor(first, dtype=torch.int32).to(device))


def parse_words(words: torch.Tensor, table: torch.Tensor, first: torch.Tensor,
                *, n_words: int) -> torch.Tensor:
    """Launch the parser on ``words``' CUDA device; returns ``[B, F]``."""
    global LAUNCHES
    if words.device.type != "cuda":
        raise ValueError(f"parse_words launches a CUDA kernel; got a tensor on "
                         f"{words.device} (the plain version is ref.py)")
    dev = words.device
    b = words.shape[0]
    n_fields = first.shape[0] - 1
    n_pieces = table.shape[0]
    check_tensor(words, "words", torch.uint32, (b, n_words), dev)
    check_tensor(table, "table", torch.int32, (n_pieces, 5), dev)
    check_tensor(first, "first", torch.int32, (n_fields + 1,), dev)
    lib = _lib()
    cap = lib.parser_max_pieces()
    if n_pieces > cap or n_fields > cap:
        raise ValueError(f"{n_fields} fields in {n_pieces} pieces exceed the "
                         f"kernel's table of {cap}")
    out = torch.empty((b, n_fields), dtype=torch.uint32, device=dev)
    if b == 0 or n_fields == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.parse_headers_u32(words.data_ptr(), table.data_ptr(),
                                     first.data_ptr(), out.data_ptr(), b,
                                     n_words, n_fields, n_pieces, stream)
    check_launch(code, "parse_words")
    LAUNCHES += 1
    return out
