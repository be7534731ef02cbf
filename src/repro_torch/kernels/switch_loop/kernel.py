"""Binding of the hand-written cycle-loop kernel (``csrc/switch_loop.cu``).

Replaces the JAX package's jitted ``lax.scan`` over cycles
(``switch/switch.py``, ``simulate``) and the Pallas iSLIP tile it reaches
(``kernels/islip/kernel.py``, ``islip_schedule_padded``): every cycle of a
simulation in one launch, one warp, lane = port.  Bound by the serial chain
of dependent cycles (see the note at the top of the CUDA source).

An architecture whose custom kernel carries a Python ``fn`` runs in two
launches of the same kernel with the hooks stepped on the host between
them (``ops.switch_loop``): ``switch_ingress_launch`` (every cycle's parse,
learn and lookup -> ``out`` [T, N]) and ``switch_egress_launch`` (every
cycle's enqueue onward, on the hooked ``out`` and ``valid``), held to
``ref.ingress_ref`` and ``ref.egress_ref``.  ``switch_loop_launch``, the
fused form, takes no such architecture.

Contract: ``arr_pid`` [T, N] int32, ``words`` [npkt, W] uint32 (the packed
headers), ``size_flits`` [npkt] int32, all on one CUDA device and
contiguous, the architecture, and the routing and src keys' baked slices
(``kernels.parser.bake_slices(protocol, [routing_key, src_key])``, at most
two pieces a key): the kernel parses each arriving header at ingress, as
the reference's cycle step does.  Each packet id appears at most once in
``arr_pid`` (as ``prepare_cycle_inputs`` bins a trace).
Returns ``SwitchLoopOut``, bitwise equal to ``ref.switch_loop_ref``.  N <=
32 ports, hash banks <= 32, full-lookup address bits <= 30.  ``plan``
places the forward table and the VOQ ring in shared memory where they fit.
The wrappers never synchronise.  ``LAUNCHES``, ``INGRESS_LAUNCHES`` and
``EGRESS_LAUNCHES`` count each form's launches in this process.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.archspec import (ForwardTableKind, SchedulerKind,
                                       SwitchArch, VOQKind)
from repro_torch.switch.forward_table import _HASH_MULTS
from ..build import (MAX_SMEM_BYTES, KernelError, check_launch, check_tensor,
                     library)
from ..parser.ref import WORD_BITS, Baked
from . import hooks
from .ref import SwitchLoopOut

__all__ = ["EGRESS_LAUNCHES", "INGRESS_LAUNCHES", "LAUNCHES", "MAX_PORTS", "KeyPieces",
           "Plan", "chain_step", "key_pieces", "plan", "switch_egress_launch",
           "switch_ingress_launch", "switch_loop_launch"]

#: kernel launches since the counter was last reset (``chip_smoke.py`` sets
#: it to 0 before the main path and reads it after)
LAUNCHES = 0
#: launches of the ingress and of the egress pass (an architecture with hooks)
INGRESS_LAUNCHES = 0
EGRESS_LAUNCHES = 0
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


def plan(arch: SwitchArch, npkt: int, mode: str = "fused") -> Plan:
    """Where the kernel keeps its state for ``arch`` and ``npkt`` packets:
    the per-queue counters always in shared memory, then the forward table
    and then the VOQ ring where they still fit in the 227 KB a block may
    use.  ``mode`` "ingress" keeps only the table, "egress" only the
    counters and the ring.  Raises for an architecture the kernel does not
    take."""
    if mode not in ("fused", "ingress", "egress"):
        raise ValueError(f"mode must be fused, ingress or egress, got {mode!r}")
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
    if mode == "ingress":
        ring_words = 0
    if mode == "egress":
        table_words = 0
    # occupancy, ring head, occupancy max
    smem = 0 if mode == "ingress" else 3 * n * (n + 1) * 4
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
            raise KernelError("csrc/switch_loop.cu's KeyPieces and kernel.KeyPieces "
                              "differ in size")
        lib.switch_loop_i32.argtypes = [_P] * 3 + [_I] + [_P] * 9 + [_I] * 13 + [_P]
        lib.switch_loop_i32.restype = ctypes.c_int
        lib.switch_ingress_i32.argtypes = [_P] * 3 + [_I] + [_P] * 3 + [_I] * 8 + [_P]
        lib.switch_ingress_i32.restype = ctypes.c_int
        lib.switch_egress_i32.argtypes = [_P] * 10 + [_I] * 8 + [_P]
        lib.switch_egress_i32.restype = ctypes.c_int
        lib.switch_loop_chain.argtypes = [_P, _I, _P]
        lib.switch_loop_chain.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _mults(banks: int, dev: torch.device) -> torch.Tensor:
    """The hash banks' multipliers on ``dev`` ([0] without banks), copied
    there once: a launch makes no host-to-device copy."""
    vals = [_HASH_MULTS[b % len(_HASH_MULTS)] for b in range(banks)] or [0]
    return torch.tensor(vals, dtype=torch.int64).to(torch.uint32).to(dev)


def _check_inputs(what: str, arch: SwitchArch, arr_pid: torch.Tensor,
                  words: torch.Tensor, key_slices: Baked) -> KeyPieces:
    """Raise unless ``arr_pid`` [T, N] int32 and ``words`` [npkt, W] uint32
    lie on one CUDA device and the keys read words a header has."""
    if arr_pid.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; got a tensor on "
                         f"{arr_pid.device} (the plain version is ref.py)")
    kp = key_pieces(key_slices)
    if arr_pid.dim() != 2 or words.dim() != 2:
        raise ValueError(f"arr_pid must be [T, N] and words [npkt, W], got "
                         f"{tuple(arr_pid.shape)} and {tuple(words.shape)}")
    last = max((p[0] for pieces in key_slices for p in pieces), default=-1)
    if last >= words.shape[1]:
        raise ValueError(f"the keys read header word {last}, but a header has "
                         f"{words.shape[1]}")
    check_tensor(arr_pid, "arr_pid", torch.int32, (arr_pid.shape[0], arch.n_ports),
                 arr_pid.device)
    check_tensor(words, "words", torch.uint32, tuple(words.shape), arr_pid.device)
    return kp


def _table_args(arch: SwitchArch, p: Plan, dev):
    """The forward table's kernel arguments: the banks' multipliers, the
    table in device memory (None when in shared memory), kind, address
    bits, banks and depth."""
    hashed = arch.fwd is ForwardTableKind.MULTIBANK_HASH
    gtable = None if p.table_shared else torch.empty((p.table_words,), dtype=torch.int32,
                                                     device=dev)
    return (_mults(arch.hash_banks if hashed else 0, dev), gtable, _FWD[arch.fwd],
            0 if hashed else arch.addr_bits, arch.hash_banks if hashed else 0,
            arch.hash_depth if hashed else 0)


def _egress_outputs(arch: SwitchArch, p: Plan, t: int, npkt: int, dev):
    """The queue side's buffers: Shared-VOQ refcounts, departure cycles,
    occupancy trace and maxima, the 3 counters and the ring in device
    memory (None when in shared memory)."""
    i64 = dict(dtype=torch.int64, device=dev)
    shared = arch.voq is VOQKind.SHARED
    rem = torch.zeros((max(npkt, 1) if shared else 1,), dtype=torch.int32, device=dev)
    gring = None if p.ring_shared else torch.empty((p.ring_words,), dtype=torch.int32,
                                                   device=dev)
    return (rem, torch.full((max(npkt, 1),), -1, **i64), torch.empty((t,), **i64),
            torch.empty((arch.n_ports, arch.n_ports), **i64), torch.empty((3,), **i64),
            gring)


def _ptr(x):
    return None if x is None else x.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def switch_loop_launch(arch: SwitchArch, arr_pid: torch.Tensor, words: torch.Tensor,
                       size_flits: torch.Tensor, key_slices: Baked) -> SwitchLoopOut:
    """Launch one simulation on ``arr_pid``'s CUDA device, every stage of
    every cycle (no hooks: an architecture whose custom kernel carries a
    Python ``fn`` runs through the two passes)."""
    global LAUNCHES
    if hooks.has_hooks(arch):
        raise ValueError("the fused switch loop cannot call a custom kernel's Python "
                         "fn; ops.switch_loop runs such an architecture as an ingress "
                         "and an egress pass with the hooks between them")
    kp = _check_inputs("switch_loop_launch", arch, arr_pid, words, key_slices)
    (t, n), (npkt, w), dev = arr_pid.shape, words.shape, arr_pid.device
    check_tensor(size_flits, "size_flits", torch.int32, (npkt,), dev)
    p = plan(arch, npkt)
    mults, gtable, fwd, bits, banks, depth = _table_args(arch, p, dev)
    rem, dep_cycle, occ_trace, occ_max, scalars, gring = _egress_outputs(arch, p, t,
                                                                          npkt, dev)
    with torch.cuda.device(dev):
        code = _lib().switch_loop_i32(
            arr_pid.data_ptr(), words.data_ptr(), ctypes.byref(kp), w,
            size_flits.data_ptr(), mults.data_ptr(),
            rem.data_ptr(), dep_cycle.data_ptr(), occ_trace.data_ptr(), occ_max.data_ptr(),
            scalars.data_ptr(), _ptr(gtable), _ptr(gring), t, n, arch.voq_depth,
            fwd, _VOQ[arch.voq], _SCHED[arch.sched], arch.islip_iters,
            bits, banks, depth, int(p.table_shared), int(p.ring_shared),
            p.smem_bytes, _stream(dev))
    check_launch(code, "switch_loop_launch")
    LAUNCHES += 1
    return SwitchLoopOut(dep_cycle, occ_trace, occ_max, scalars[0], scalars[1],
                         scalars[2])


def switch_ingress_launch(arch: SwitchArch, arr_pid: torch.Tensor, words: torch.Tensor,
                          key_slices: Baked) -> torch.Tensor:
    """The ingress pass on ``arr_pid``'s CUDA device: every cycle's parse,
    learn and lookup -> ``out`` [T, N] int32 (the port, -2 broadcast, -1
    no packet), bitwise ``ref.ingress_ref``."""
    global INGRESS_LAUNCHES
    kp = _check_inputs("switch_ingress_launch", arch, arr_pid, words, key_slices)
    (t, n), (npkt, w), dev = arr_pid.shape, words.shape, arr_pid.device
    p = plan(arch, npkt, "ingress")
    mults, gtable, fwd, bits, banks, depth = _table_args(arch, p, dev)
    out = torch.empty((t, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = _lib().switch_ingress_i32(
            arr_pid.data_ptr(), words.data_ptr(), ctypes.byref(kp), w, mults.data_ptr(),
            out.data_ptr(), _ptr(gtable), t, n, fwd, bits, banks, depth,
            int(p.table_shared), p.smem_bytes, _stream(dev))
    check_launch(code, "switch_ingress_launch")
    INGRESS_LAUNCHES += 1
    return out


def switch_egress_launch(arch: SwitchArch, arr_pid: torch.Tensor, out: torch.Tensor,
                         valid: torch.Tensor, size_flits: torch.Tensor) -> SwitchLoopOut:
    """The egress pass on ``arr_pid``'s CUDA device: every cycle's enqueue
    of the lanes ``valid`` [T, N] bool marks to the hooked ``out`` [T, N]
    int32, the schedule, the dequeue and the bookkeeping ->
    ``SwitchLoopOut``, bitwise ``ref.egress_ref``."""
    global EGRESS_LAUNCHES
    if arr_pid.device.type != "cuda":
        raise ValueError(f"switch_egress_launch launches a CUDA kernel; got a tensor "
                         f"on {arr_pid.device} (the plain version is ref.py)")
    dev = arr_pid.device
    if arr_pid.dim() != 2:
        raise ValueError(f"arr_pid must be [T, N], got {tuple(arr_pid.shape)}")
    t, n, npkt = arr_pid.shape[0], arch.n_ports, size_flits.shape[0]
    check_tensor(arr_pid, "arr_pid", torch.int32, (t, n), dev)
    check_tensor(out, "out", torch.int32, (t, n), dev)
    check_tensor(valid, "valid", torch.bool, (t, n), dev)
    check_tensor(size_flits, "size_flits", torch.int32, (npkt,), dev)
    p = plan(arch, npkt, "egress")
    rem, dep_cycle, occ_trace, occ_max, scalars, gring = _egress_outputs(arch, p, t,
                                                                          npkt, dev)
    with torch.cuda.device(dev):
        code = _lib().switch_egress_i32(
            arr_pid.data_ptr(), out.data_ptr(), valid.data_ptr(), size_flits.data_ptr(),
            rem.data_ptr(), dep_cycle.data_ptr(), occ_trace.data_ptr(), occ_max.data_ptr(),
            scalars.data_ptr(), _ptr(gring), t, n, arch.voq_depth, _VOQ[arch.voq],
            _SCHED[arch.sched], arch.islip_iters, int(p.ring_shared), p.smem_bytes,
            _stream(dev))
    check_launch(code, "switch_egress_launch")
    EGRESS_LAUNCHES += 1
    return SwitchLoopOut(dep_cycle, occ_trace, occ_max, scalars[0], scalars[1],
                         scalars[2])


def chain_step(io: torch.Tensor, steps: int) -> None:
    """``steps`` of the least dependent step one cycle of the loop hands the
    next (a ballot of the busy outputs, a shuffle of the hold, a maximum) on
    one warp of ``io``'s device, in place: ``io`` [32] int32, one value a
    lane.  Times the step; not a launch of the loop."""
    check_tensor(io, "io", torch.int32, (32,), io.device)
    with torch.cuda.device(io.device):
        stream = torch.cuda.current_stream(io.device).cuda_stream
        code = _lib().switch_loop_chain(io.data_ptr(), steps, stream)
    check_launch(code, "switch_loop_chain")
