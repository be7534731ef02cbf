"""Binding of the hand-written ring-scan stage-4 kernel (``csrc/ring_scan.cu``).

Replaces the JAX package's ``sim/batched_netsim.py:_verify_engine_impl``,
the float64 ``lax.scan`` that ``use_kernel="off"`` selects (it has no Pallas
counterpart).  One candidate row per block of one warp: lane p & 31 holds
port p's free times (``csrc/port_scan.cuh``), the row's admission counters
sit in shared memory while they fit (``tail_in_smem``), the departure ring
in global memory.

Contract: ``now`` [m] float64, ``src``/``dst`` [m] int32, ``svc_t`` [m, B]
float64 (event-major), ``pipe`` [B] float64, ``depth``/``mod`` [B] int32
with 1 <= mod <= d_max → ``end`` [B, m] float64 and ``admit`` [B, m] bool,
bitwise equal to ``ref.py``.  ``LAUNCHES`` counts the kernel launches of
this process.  ``chain_step`` runs the scan's step alone, ``steps`` times in
a dependent chain on one thread (for the chain bound ``chip_smoke.py``
reports); it is not the scan and is not counted.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..build import MAX_SMEM_BYTES, check_launch, check_ports, check_tensor, library

__all__ = ["LAUNCHES", "chain_step", "ring_scan", "tail_in_smem"]

#: kernel launches since the counter was last reset (``chip_smoke.py`` sets
#: it to 0 before the main path and reads it after)
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = library("ring_scan")
    if not getattr(lib, "_spac_typed", False):
        lib.ring_scan_f64.argtypes = [_P] * 11 + [_I] * 5 + [_P]
        lib.ring_scan_f64.restype = ctypes.c_int
        lib.ring_scan_smem_bytes.argtypes = [_I, _I]
        lib.ring_scan_smem_bytes.restype = ctypes.c_longlong
        lib.ring_scan_chain.argtypes = [_P, _P, _I, _I, _I, _P]
        lib.ring_scan_chain.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def tail_in_smem(n_ports: int) -> bool:
    """Whether a row's ``n_ports ** 2`` admission counters sit in shared
    memory (up to 241 ports) or in a zeroed global array."""
    return _lib().ring_scan_smem_bytes(n_ports, 1) <= MAX_SMEM_BYTES


def ring_scan(now: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              svc_t: torch.Tensor, pipe: torch.Tensor, depth: torch.Tensor,
              mod: torch.Tensor, *, n_ports: int,
              d_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the scan on ``svc_t``'s CUDA device; returns ``(end, admit)``,
    each ``[B, m]``.  The ring, ``B * n_ports**2 * d_max`` float64, is
    allocated here (``ops.ring_scan`` splits the rows under a budget)."""
    global LAUNCHES
    if svc_t.device.type != "cuda":
        raise ValueError(f"ring_scan launches a CUDA kernel; got a tensor on "
                         f"{svc_t.device} (the plain version is ref.py)")
    if svc_t.dim() != 2:
        raise ValueError(f"svc_t must be [m, B], got shape {tuple(svc_t.shape)}")
    m, b = svc_t.shape
    dev = svc_t.device
    check_tensor(svc_t, "svc_t", torch.float64, (m, b), dev)
    check_tensor(now, "now", torch.float64, (m,), dev)
    check_tensor(src, "src", torch.int32, (m,), dev)
    check_tensor(dst, "dst", torch.int32, (m,), dev)
    check_tensor(pipe, "pipe", torch.float64, (b,), dev)
    check_tensor(depth, "depth", torch.int32, (b,), dev)
    check_tensor(mod, "mod", torch.int32, (b,), dev)
    if not 1 <= n_ports < 65536:
        raise ValueError(f"n_ports must lie in [1, 65536), got {n_ports}")
    end = torch.empty((b, m), dtype=torch.float64, device=dev)
    admit = torch.empty((b, m), dtype=torch.uint8, device=dev)
    if m == 0 or b == 0:
        return end, admit.view(torch.bool)
    check_ports(src, dst, n_ports)
    lo, hi = torch.stack(torch.aminmax(mod)).tolist()
    if lo < 1 or hi > d_max:
        raise ValueError(f"mod must lie in [1, d_max={d_max}], got [{lo}, {hi}]")
    q_n = n_ports * n_ports
    lib = _lib()
    smem_tail = tail_in_smem(n_ports)
    smem = lib.ring_scan_smem_bytes(n_ports, int(smem_tail))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"n_ports={n_ports} needs {smem} B of shared memory "
                         f"per block, above the {MAX_SMEM_BYTES} B Hopper has")
    ring = torch.empty((b, q_n, d_max), dtype=torch.float64, device=dev)
    tail = (None if smem_tail
            else torch.zeros((b, q_n), dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.ring_scan_f64(
            now.data_ptr(), src.data_ptr(), dst.data_ptr(), svc_t.data_ptr(),
            pipe.data_ptr(), depth.data_ptr(), mod.data_ptr(), ring.data_ptr(),
            None if tail is None else tail.data_ptr(), end.data_ptr(),
            admit.data_ptr(), m, b, n_ports, d_max, int(smem_tail), stream)
    check_launch(code, "ring_scan")
    LAUNCHES += 1
    return end, admit.view(torch.bool)


def chain_step(io: torch.Tensor, ring: torch.Tensor, steps: int, *, mod: int,
               depth: int) -> None:
    """``steps`` dependent steps of the scan's step on one thread of
    ``io``'s device, in place: ``io`` [6] float64 holds x0, o, t, pipe, s
    and t's increment per step; ``ring`` at least ``mod`` float64;
    ``io[0]`` gets the result."""
    check_tensor(io, "io", torch.float64, (6,), io.device)
    if ring.dtype != torch.float64 or ring.numel() < mod or mod < 1:
        raise ValueError("ring must hold at least mod >= 1 float64")
    with torch.cuda.device(io.device):
        stream = torch.cuda.current_stream(io.device).cuda_stream
        code = _lib().ring_scan_chain(io.data_ptr(), ring.data_ptr(), mod,
                                      depth, steps, stream)
    check_launch(code, "ring_scan_chain")
