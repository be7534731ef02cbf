"""Binding of the hand-written cycle-loop kernel (``csrc/switch_loop.cu``).

Replaces the JAX package's jitted ``lax.scan`` over cycles
(``switch/switch.py``, ``simulate``) and the Pallas iSLIP tile it reaches
(``kernels/islip/kernel.py``, ``islip_schedule_padded``): every cycle of a
simulation in one launch, one warp, lane = port.  Bound by the serial chain
of dependent cycles (see the note at the top of the CUDA source).

Contract: ``arr_pid`` [T, N] int32, ``words`` [npkt, W] uint32 (the packed
headers), ``size_flits`` [npkt] int32, all on one CUDA device and
contiguous, the architecture, and the routing and src keys' baked slices
(``kernels.parser.bake_slices(protocol, [routing_key, src_key])``, at most
two pieces a key): the kernel parses each arriving header at ingress, as
the reference's cycle step does.  Each packet id appears at most once in
``arr_pid`` (as ``prepare_cycle_inputs`` bins a trace).
Returns ``SwitchLoopOut``, bitwise equal to ``ref.switch_loop_ref``.  N <=
32 ports, hash banks <= 32, full-lookup address bits <= 30; an architecture
whose custom kernel carries a Python ``fn`` is refused (it runs on the
CPU).  ``plan`` places the forward table and the VOQ ring in shared
memory where they fit.  The wrapper never synchronises.  ``LAUNCHES``
counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.archspec import (ForwardTableKind, SchedulerKind,
                                       SwitchArch, VOQKind)
from repro_torch.switch.forward_table import _HASH_MULTS
from ..build import MAX_SMEM_BYTES, check_launch, check_tensor, library
from ..parser.ref import WORD_BITS, Baked
from .ref import SwitchLoopOut

__all__ = ["LAUNCHES", "MAX_PORTS", "KeyPieces", "Plan", "key_pieces", "plan",
           "switch_loop_launch"]

#: kernel launches since the counter was last reset (``chip_smoke.py`` sets
#: it to 0 before the main path and reads it after)
LAUNCHES = 0
#: one lane per port
MAX_PORTS = 32
#: one lane per hash bank when a port learns
MAX_BANKS = 32
MAX_ADDR_BITS = 30

_FWD = {ForwardTableKind.FULL_LOOKUP: 0, ForwardTableKind.MULTIBANK_HASH: 1}
_VOQ = {VOQKind.NXN: 0, VOQKind.SHARED: 1}
_SCHED = {SchedulerKind.RR: 0, SchedulerKind.ISLIP: 1, SchedulerKind.EDRRM: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int


class KeyPieces(ctypes.Structure):
    """The routing key's (0) and the src key's (1) pieces as the kernel
    reads them (``csrc/switch_loop.cu``'s struct): piece j of key f is
    ``((header word word[f][j] >> lo) & mask) << dst``; a key of one piece
    has a second of mask 0."""
    _fields_ = [("word", (ctypes.c_int * 2) * 2), ("lo", (ctypes.c_int * 2) * 2),
                ("dst", (ctypes.c_int * 2) * 2), ("mask", (ctypes.c_uint32 * 2) * 2)]


@functools.lru_cache(maxsize=None)
def key_pieces(key_slices: Baked) -> KeyPieces:
    """The two keys' baked slices as the kernel's struct.  Raises unless
    there are two keys of at most two pieces each."""
    if len(key_slices) != 2 or any(len(p) > 2 for p in key_slices):
        raise ValueError(f"the switch-loop kernel parses a routing and a src key of "
                         f"at most two pieces each, got {key_slices}")
    kp = KeyPieces()
    for f, pieces in enumerate(key_slices):
        for j, (w, lo, take, dst) in enumerate(pieces):
            kp.word[f][j], kp.lo[f][j], kp.dst[f][j] = w, lo, dst
            kp.mask[f][j] = (1 << take) - 1 if take < WORD_BITS else 0xFFFFFFFF
    return kp


class Plan(NamedTuple):
    smem_bytes: int      # dynamic shared memory of the launch
    table_shared: bool   # forward table in shared memory (else global)
    ring_shared: bool    # VOQ ring [N, N, D] in shared memory (else global)
    table_words: int     # int32 words of the forward table
    ring_words: int      # int32 words of the VOQ ring


def plan(arch: SwitchArch, npkt: int) -> Plan:
    """Where the kernel keeps its state for ``arch`` and ``npkt`` packets:
    the per-queue counters always in shared memory, then the forward table
    and then the VOQ ring where they still fit in the 227 KB a block may
    use.  Raises for an architecture the kernel does not take."""
    n, d = arch.n_ports, arch.voq_depth
    if not 1 <= n <= MAX_PORTS:
        raise ValueError(f"the switch-loop kernel takes 1..{MAX_PORTS} ports, got {n}")
    if d < 1:
        raise ValueError(f"voq_depth must be >= 1, got {d}")
    if arch.fwd is ForwardTableKind.FULL_LOOKUP:
        if not 0 <= arch.addr_bits <= MAX_ADDR_BITS:
            raise ValueError(f"full lookup takes 0..{MAX_ADDR_BITS} address bits, "
                             f"got {arch.addr_bits}")
        table_words = 1 << arch.addr_bits
    else:
        if not 1 <= arch.hash_banks <= MAX_BANKS or arch.hash_depth < 1:
            raise ValueError(f"the hash table takes 1..{MAX_BANKS} banks of depth "
                             f">= 1, got {arch.hash_banks} x {arch.hash_depth}")
        table_words = 2 * arch.hash_banks * arch.hash_depth
    ring_words = n * n * d
    if ring_words >= 2 ** 31:
        raise ValueError(f"the VOQ ring [{n}, {n}, {d}] exceeds int32 indexing")
    smem = 3 * n * (n + 1) * 4            # occupancy, ring head, occupancy max
    table_shared = smem + 4 * table_words <= MAX_SMEM_BYTES
    smem += 4 * table_words if table_shared else 0
    ring_shared = smem + 4 * ring_words <= MAX_SMEM_BYTES
    smem += 4 * ring_words if ring_shared else 0
    return Plan(smem, table_shared, ring_shared, table_words, ring_words)


def _lib():
    lib = library("switch_loop")
    if not getattr(lib, "_spac_typed", False):
        lib.switch_loop_key_pieces_bytes.restype = ctypes.c_int
        if lib.switch_loop_key_pieces_bytes() != ctypes.sizeof(KeyPieces):
            raise RuntimeError("csrc/switch_loop.cu's KeyPieces and kernel.KeyPieces "
                               "differ in size")
        lib.switch_loop_i32.argtypes = [_P] * 3 + [_I] + [_P] * 9 + [_I] * 13 + [_P]
        lib.switch_loop_i32.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def switch_loop_launch(arch: SwitchArch, arr_pid: torch.Tensor, words: torch.Tensor,
                       size_flits: torch.Tensor, key_slices: Baked) -> SwitchLoopOut:
    """Launch one simulation on ``arr_pid``'s CUDA device."""
    global LAUNCHES
    if any(k.fn is not None for k in arch.custom_kernels):
        raise ValueError("a custom kernel's Python fn cannot run inside the CUDA "
                         "kernel; simulate such an architecture with device=\"cpu\"")
    if arr_pid.device.type != "cuda":
        raise ValueError(f"switch_loop_launch launches a CUDA kernel; got a tensor on "
                         f"{arr_pid.device} (the plain version is ref.py)")
    kp = key_pieces(key_slices)
    if arr_pid.dim() != 2 or words.dim() != 2:
        raise ValueError(f"arr_pid must be [T, N] and words [npkt, W], got "
                         f"{tuple(arr_pid.shape)} and {tuple(words.shape)}")
    n, (npkt, w) = arch.n_ports, words.shape
    last = max((p[0] for pieces in key_slices for p in pieces), default=-1)
    if last >= w:
        raise ValueError(f"the keys read header word {last}, but a header has {w}")
    p = plan(arch, npkt)
    dev = arr_pid.device
    t = arr_pid.shape[0]
    check_tensor(arr_pid, "arr_pid", torch.int32, (t, n), dev)
    check_tensor(words, "words", torch.uint32, (npkt, w), dev)
    check_tensor(size_flits, "size_flits", torch.int32, (npkt,), dev)
    i64 = dict(dtype=torch.int64, device=dev)
    dep_cycle = torch.full((max(npkt, 1),), -1, **i64)
    occ_trace = torch.empty((t,), **i64)
    occ_max = torch.empty((n, n), **i64)
    scalars = torch.empty((3,), **i64)
    shared = arch.voq is VOQKind.SHARED
    rem = torch.zeros((max(npkt, 1) if shared else 1,), dtype=torch.int32, device=dev)
    hashed = arch.fwd is ForwardTableKind.MULTIBANK_HASH
    mults = torch.tensor([_HASH_MULTS[b % len(_HASH_MULTS)] for b in range(arch.hash_banks)]
                         if hashed else [0], dtype=torch.int64).to(torch.uint32).to(dev)
    gtable = None if p.table_shared else torch.empty((p.table_words,), dtype=torch.int32,
                                                     device=dev)
    gring = None if p.ring_shared else torch.empty((p.ring_words,), dtype=torch.int32,
                                                   device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.switch_loop_i32(
            arr_pid.data_ptr(), words.data_ptr(), ctypes.byref(kp), w,
            size_flits.data_ptr(), mults.data_ptr(),
            rem.data_ptr(), dep_cycle.data_ptr(), occ_trace.data_ptr(), occ_max.data_ptr(),
            scalars.data_ptr(), ptr(gtable), ptr(gring), t, n, arch.voq_depth,
            _FWD[arch.fwd], _VOQ[arch.voq], _SCHED[arch.sched], arch.islip_iters,
            0 if hashed else arch.addr_bits, arch.hash_banks if hashed else 0,
            arch.hash_depth if hashed else 0, int(p.table_shared), int(p.ring_shared),
            p.smem_bytes, stream)
    check_launch(code, "switch_loop_launch")
    LAUNCHES += 1
    return SwitchLoopOut(dep_cycle, occ_trace, occ_max, scalars[0], scalars[1],
                         scalars[2])
