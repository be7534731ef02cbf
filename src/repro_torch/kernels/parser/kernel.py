"""Binding of the hand-written header-parser kernel (``csrc/parser.cu``).

Replaces the JAX package's generated Pallas parser
``kernels/parser/kernel.py`` (``make_parser`` and its ``_kernel`` closure).
The protocol's baked slices ``(field, word, lo, take, dst_shift)`` travel
with each launch as one packed kernel parameter (``Table``, the C struct's
layout), so one compiled kernel parses every protocol; tiles of rows stream
through shared memory by TMA bulk copies.  Bound by bytes (each header read
once, each field written once); see the note at the top of the CUDA source.

Contract: ``words`` [B, W] uint32 → ``[B, F]`` uint32 fields, bitwise equal
to ``ref.parse_ref``.  At most ``MAX_WORDS`` words a header, ``MAX_FIELDS``
fields and ``MAX_PIECES`` pieces.  A call allocates its output and launches:
no copy to the card and no synchronisation.  ``LAUNCHES`` counts the kernel
launches of this process.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..build import MAX_SMEM_BYTES, check_launch, library
from .ref import WORD_BITS, Baked

__all__ = ["LAUNCHES", "MAX_FIELDS", "MAX_PIECES", "MAX_WORDS", "Plan", "Table",
           "pack_table", "parse_words", "plan"]

#: kernel launches since the counter was last reset (``chip_smoke.py`` sets
#: it to 0 before the main path and reads it after)
LAUNCHES = 0
#: the C struct's capacity (``csrc/parser.cu``: MAX_PIECES); a field has
#: at least one piece
MAX_PIECES = 256
MAX_FIELDS = MAX_PIECES
#: a piece's word index is 16 bits; a tile of 32 rows of 256 words, in its
#: input stages, fits in a block's shared memory beside its output
MAX_WORDS = 256
#: Piece.dst's flag: the last piece of its field
LAST = 0x80
#: a tile holds about this many words of input and output together, and at
#: most this many blocks per SM walk the tiles (measured best of 1,536 to
#: 24,576 words and 1 to 8 blocks, PERF.md, PR 19)
TILE_WORDS = 3072
BLOCKS_PER_SM = 4
#: csrc/parser.cu's input and output tiles in flight a block, and its
#: mbarriers' bytes
STAGES_IN, STAGES_OUT = 3, 2
BARRIER_BYTES = 64


class _Piece(ctypes.Structure):
    _fields_ = [("mask", ctypes.c_uint32), ("word", ctypes.c_uint16),
                ("lo", ctypes.c_uint8), ("dst", ctypes.c_uint8)]


class Table(ctypes.Structure):
    """The kernel's parameter: the fields' pieces in order, each
    ``((word >> lo) & mask) << (dst & 31)``, a field complete at its piece
    with ``LAST`` set in ``dst``."""
    _fields_ = [("piece", _Piece * MAX_PIECES), ("n_fields", ctypes.c_int32),
                ("n_pieces", ctypes.c_int32), ("min_words", ctypes.c_int32)]


class Plan(NamedTuple):
    rows: int         # rows of a tile (a multiple of 32)
    smem_bytes: int   # dynamic shared memory of a block


def pack_table(baked: Baked) -> Table:
    """``bake_slices``' pieces as the kernel's parameter (a field without a
    piece gets one of mask 0).  Raises above the struct's capacity."""
    pieces = [list(p) or [(0, 0, 0, 0)] for p in baked]
    n_pieces = sum(map(len, pieces))
    if n_pieces > MAX_PIECES:
        raise ValueError(f"{len(baked)} fields in {n_pieces} pieces exceed the "
                         f"kernel's table of {MAX_PIECES} pieces")
    tab = Table()
    i = 0
    for field in pieces:
        for j, (word, lo, take, dst_shift) in enumerate(field):
            if word >= MAX_WORDS:
                raise ValueError(f"word {word} exceeds the kernel's {MAX_WORDS} words")
            p = tab.piece[i]
            p.mask = (1 << take) - 1 if take < WORD_BITS else 0xFFFFFFFF
            p.word, p.lo = word, lo
            p.dst = dst_shift | (LAST if j == len(field) - 1 else 0)
            i += 1
    tab.n_fields, tab.n_pieces = len(baked), n_pieces
    tab.min_words = 1 + max((p[0] for field in baked for p in field), default=-1)
    return tab


@functools.lru_cache(maxsize=1024)
def plan(n_words: int, n_fields: int, n_rows: int = 0, sms: int = 0) -> Plan:
    """A tile's rows and a block's shared memory for W words in and F
    fields out (and ``n_rows`` rows on ``sms`` SMs: a batch too small to
    fill them gets smaller tiles, one a block, so that it still reaches
    every SM).  Raises for a shape the kernel does not take."""
    if not 1 <= n_words <= MAX_WORDS:
        raise ValueError(f"the parser takes 1..{MAX_WORDS} words a header, got {n_words}")
    if not 0 <= n_fields <= MAX_FIELDS:
        raise ValueError(f"the parser takes 0..{MAX_FIELDS} fields, got {n_fields}")
    rows = max(32, TILE_WORDS // (n_words + n_fields) // 32 * 32)
    if n_rows and sms:
        rows = min(rows, max(32, -(-n_rows // sms) + 31) // 32 * 32)
    smem = BARRIER_BYTES + 4 * rows * (STAGES_IN * n_words + STAGES_OUT * n_fields)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{n_words} words and {n_fields} fields exceed a block's "
                         f"shared memory")
    return Plan(rows, smem)


_FN = None
_SMS = {}


def _launcher():
    """The C launcher, typed and checked against ``Table`` once."""
    global _FN
    if _FN is None:
        lib = library("parser")
        lib.parser_table_bytes.restype = ctypes.c_int
        if lib.parser_table_bytes() != ctypes.sizeof(Table):
            raise RuntimeError(f"csrc/parser.cu's Table is {lib.parser_table_bytes()} "
                               f"bytes, kernel.Table {ctypes.sizeof(Table)}")
        fn = lib.parse_headers_u32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _sms(dev: torch.device) -> int:
    sms = _SMS.get(dev.index)
    if sms is None:
        sms = _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms


def _stream(dev: torch.device) -> int:
    """The current stream's handle (without building a ``torch.cuda.Stream``
    where the build exposes the raw one)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(dev.index) if raw is not None else torch.cuda.current_stream(dev).cuda_stream


def parse_words(words: torch.Tensor, table: Table) -> torch.Tensor:
    """Launch the parser on ``words``' CUDA device; returns ``[B, F]``."""
    global LAUNCHES
    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"parse_words launches a CUDA kernel; got a tensor on "
                         f"{dev} (the plain version is ref.py)")
    if words.dim() != 2 or words.dtype != torch.uint32 or not words.is_contiguous():
        raise ValueError(f"words must be a contiguous [B, W] uint32 tensor, got "
                         f"{words.dtype} {tuple(words.shape)}")
    b, w = words.shape
    if w < table.min_words:
        raise ValueError(f"the protocol reads {table.min_words} words a header, "
                         f"got {w}")
    sms = _sms(dev)
    p = plan(w, table.n_fields, b, sms)
    out = torch.empty((b, table.n_fields), dtype=torch.uint32, device=dev)
    if b == 0 or table.n_fields == 0:
        return out
    fn = _launcher()
    blocks = min(-(-b // p.rows), BLOCKS_PER_SM * sms)
    args = (words.data_ptr(), out.data_ptr(), ctypes.byref(table), b, w, p.rows,
            blocks, p.smem_bytes, _stream(dev))
    if dev.index == torch.cuda.current_device():
        code = fn(*args)
    else:
        with torch.cuda.device(dev):
            code = fn(*args)
    check_launch(code, "parse_words")
    LAUNCHES += 1
    return out
