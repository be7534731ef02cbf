"""Binding of the hand-written admission-gated replay kernel (``csrc/netsim.cu``).

Replaces the JAX package's Pallas tile ``kernels/netsim/kernel.py``
(``netsim_replay_padded``) and the float64 ``lax.scan`` twins stage 4 runs:
round 1's ungated replay (``kernels/netsim/ops.py:_round1_body``) and the
gated replay of later rounds (``kernels/netsim/ref.py:netsim_replay_abs_ref``).
One candidate row per warp (``csrc/port_scan.cuh``, shared with the
crossbar scan): the absolute forms run each 32-event group by levels of its
dependency graph, the slack form one event a step with lane p holding port
p in registers; bound by the dependent chain, not by bandwidth (see the
CUDA source's note).

Contract: ``tnow`` [m] (absolute switch-arrival times for ``absolute=True``
in float64, inter-arrival gaps for the float32 slack form), ``src``/``dst``
[m] int32, ``svc_t`` [m, B], ``pipe`` [B], ``admit_t`` [m, B] uint8 or None
(ungated: every event admitted; the slack form is always gated) → ``[B, m]``
departure times (absolute) or offsets (slack), bitwise equal to ``ref.py``.
``LAUNCHES`` counts the kernel launches of this process.  ``chain_step``
runs one form's step alone, ``steps`` times in a dependent chain on one
thread (for the chain bound ``chip_smoke.py`` reports); it is not the
replay and is not counted.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..build import MAX_SMEM_BYTES, check_launch, check_ports, check_tensor, library

__all__ = ["LAUNCHES", "chain_step", "netsim_replay"]

#: kernel launches since the counter was last reset (``chip_smoke.py`` sets
#: it to 0 before the main path and reads it after)
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = library("netsim")
    if not getattr(lib, "_spac_typed", False):
        lib.netsim_replay_abs_f64.argtypes = [_P] * 6 + [_I, _I, _I, _P]
        for fn in (lib.netsim_replay_gated_abs_f64,
                   lib.netsim_replay_gated_slack_f32):
            fn.argtypes = [_P] * 7 + [_I, _I, _I, _P]
        for fn in (lib.netsim_replay_abs_f64, lib.netsim_replay_gated_abs_f64,
                   lib.netsim_replay_gated_slack_f32):
            fn.restype = ctypes.c_int
        lib.netsim_smem_bytes.argtypes = [_I, _I]
        lib.netsim_smem_bytes.restype = ctypes.c_longlong
        lib.netsim_chain.argtypes = [_I, _P, _I, _P]
        lib.netsim_chain.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def netsim_replay(tnow: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  svc_t: torch.Tensor, pipe: torch.Tensor,
                  admit_t: Optional[torch.Tensor], *, n_ports: int,
                  absolute: bool) -> torch.Tensor:
    """Launch the replay on ``svc_t``'s CUDA device; returns ``[B, m]``."""
    global LAUNCHES
    if svc_t.device.type != "cuda":
        raise ValueError(f"netsim_replay launches a CUDA kernel; got a tensor "
                         f"on {svc_t.device} (the plain version is ref.py)")
    if svc_t.dim() != 2:
        raise ValueError(f"svc_t must be [m, B], got shape {tuple(svc_t.shape)}")
    if admit_t is None and not absolute:
        raise ValueError("the float32 slack replay is the gated (Pallas) "
                         "contract; pass admit_t")
    m, b = svc_t.shape
    dtype = torch.float64 if absolute else torch.float32
    dev = svc_t.device
    check_tensor(svc_t, "svc_t", dtype, (m, b), dev)
    check_tensor(tnow, "now" if absolute else "dnow", dtype, (m,), dev)
    check_tensor(src, "src", torch.int32, (m,), dev)
    check_tensor(dst, "dst", torch.int32, (m,), dev)
    check_tensor(pipe, "pipe", dtype, (b,), dev)
    if admit_t is not None:
        check_tensor(admit_t, "admit_t", torch.uint8, (m, b), dev)
    if n_ports < 1:
        raise ValueError(f"n_ports must be >= 1, got {n_ports}")
    out = torch.empty((b, m), dtype=dtype, device=dev)
    if m == 0 or b == 0:
        return out
    check_ports(src, dst, n_ports)
    lib = _lib()
    smem = lib.netsim_smem_bytes(n_ports, dtype.itemsize)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"n_ports={n_ports} needs {smem} B of shared memory "
                         f"per block, above the {MAX_SMEM_BYTES} B Hopper has")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (tnow.data_ptr(), src.data_ptr(), dst.data_ptr(),
                svc_t.data_ptr())
        tail = (pipe.data_ptr(), out.data_ptr(), m, b, n_ports, stream)
        if admit_t is None:
            code = lib.netsim_replay_abs_f64(*head, *tail)
        elif absolute:
            code = lib.netsim_replay_gated_abs_f64(*head, admit_t.data_ptr(),
                                                   *tail)
        else:
            code = lib.netsim_replay_gated_slack_f32(*head, admit_t.data_ptr(),
                                                     *tail)
    check_launch(code, "netsim_replay")
    LAUNCHES += 1
    return out


def chain_step(io: torch.Tensor, steps: int, *, absolute: bool,
               decay_only: bool = False) -> None:
    """``steps`` dependent steps of the absolute (float64) or slack
    (float32) form on one thread of ``io``'s device, in place: ``io`` [5]
    holds x0, o, now (dnow), pipe, s; ``io[0]`` gets the result.
    ``decay_only`` runs the slack form's per-event decay alone."""
    if absolute and decay_only:
        raise ValueError("the absolute form has no decay")
    dtype = torch.float64 if absolute else torch.float32
    check_tensor(io, "io", dtype, (5,), io.device)
    with torch.cuda.device(io.device):
        stream = torch.cuda.current_stream(io.device).cuda_stream
        form = 2 if decay_only else int(absolute)
        code = _lib().netsim_chain(form, io.data_ptr(), steps, stream)
    check_launch(code, "netsim_chain")
