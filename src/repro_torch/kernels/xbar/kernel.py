"""Binding of the hand-written crossbar-contention kernel (``csrc/xbar.cu``).

Replaces the JAX package's Pallas tile ``kernels/xbar/kernel.py``
(``xbar_contend_padded``) and its float64 ``lax.scan`` twin
``kernels/xbar/ref.py:xbar_contend_abs_ref``.  One candidate row per warp
(``csrc/port_scan.cuh``, shared with the netsim replay): the absolute form
runs each 32-event group by levels of its dependency graph, the slack form
one event a step with lane p holding port p in registers; bound by the
dependent chain, not by bandwidth (see the note at the top of the CUDA
source).

Contract: ``tdt`` [m] (absolute arrival times for ``absolute=True`` in
float64, inter-arrival gaps for the float32 slack form), ``src``/``dst`` [m]
int32, ``svc_t`` [m, B] (event-major, so one event's rows coalesce) →
``[B, m]`` departure times (absolute) or offsets (slack), bitwise equal to
``ref.py``.  ``LAUNCHES`` counts the kernel launches of this process.
``chain_step`` runs one form's step alone, ``steps`` times in a dependent
chain on one thread (for the chain bound ``chip_smoke.py`` reports); it is
not the scan and is not counted.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import MAX_SMEM_BYTES, check_launch, check_ports, check_tensor, library

__all__ = ["LAUNCHES", "chain_step", "xbar_scan"]

#: kernel launches since the counter was last reset (``chip_smoke.py`` sets
#: it to 0 before the main path and reads it after)
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = library("xbar")
    if not getattr(lib, "_spac_typed", False):
        for fn in (lib.xbar_scan_abs_f64, lib.xbar_scan_slack_f32):
            fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
            fn.restype = ctypes.c_int
        lib.xbar_smem_bytes.argtypes = [_I, _I]
        lib.xbar_smem_bytes.restype = ctypes.c_longlong
        lib.xbar_chain.argtypes = [_I, _P, _I, _P]
        lib.xbar_chain.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def xbar_scan(tdt: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              svc_t: torch.Tensor, *, n_ports: int,
              absolute: bool) -> torch.Tensor:
    """Launch the scan on ``svc_t``'s CUDA device; returns ``[B, m]``."""
    global LAUNCHES
    if svc_t.device.type != "cuda":
        raise ValueError(f"xbar_scan launches a CUDA kernel; got a tensor on "
                         f"{svc_t.device} (the plain version is ref.py)")
    if svc_t.dim() != 2:
        raise ValueError(f"svc_t must be [m, B], got shape {tuple(svc_t.shape)}")
    m, b = svc_t.shape
    dtype = torch.float64 if absolute else torch.float32
    dev = svc_t.device
    check_tensor(svc_t, "svc_t", dtype, (m, b), dev)
    check_tensor(tdt, "t" if absolute else "dt", dtype, (m,), dev)
    check_tensor(src, "src", torch.int32, (m,), dev)
    check_tensor(dst, "dst", torch.int32, (m,), dev)
    if n_ports < 1:
        raise ValueError(f"n_ports must be >= 1, got {n_ports}")
    out = torch.empty((b, m), dtype=dtype, device=dev)
    if m == 0 or b == 0:
        return out
    check_ports(src, dst, n_ports)
    lib = _lib()
    smem = lib.xbar_smem_bytes(n_ports, dtype.itemsize)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"n_ports={n_ports} needs {smem} B of shared memory "
                         f"per block, above the {MAX_SMEM_BYTES} B Hopper has")
    fn = lib.xbar_scan_abs_f64 if absolute else lib.xbar_scan_slack_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(tdt.data_ptr(), src.data_ptr(), dst.data_ptr(),
                  svc_t.data_ptr(), out.data_ptr(), m, b, n_ports, stream)
    check_launch(code, "xbar_scan")
    LAUNCHES += 1
    return out


def chain_step(io: torch.Tensor, steps: int, *, absolute: bool,
               decay_only: bool = False) -> None:
    """``steps`` dependent steps of the absolute (float64) or slack
    (float32) form on one thread of ``io``'s device, in place: ``io`` [5]
    holds x0, o, t (dt), pipe (unused), s; ``io[0]`` gets the result.
    ``decay_only`` runs the slack form's per-event decay alone."""
    if absolute and decay_only:
        raise ValueError("the absolute form has no decay")
    dtype = torch.float64 if absolute else torch.float32
    check_tensor(io, "io", dtype, (5,), io.device)
    with torch.cuda.device(io.device):
        stream = torch.cuda.current_stream(io.device).cuda_stream
        form = 2 if decay_only else int(absolute)
        code = _lib().xbar_chain(form, io.data_ptr(), steps, stream)
    check_launch(code, "xbar_chain")
