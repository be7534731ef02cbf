"""Greedy-crossbar contention scan, plain PyTorch versions.

The counterparts of the JAX package's ``kernels/xbar/ref.py`` oracles, with
the same names and argument layout: one shared, time-sorted trace and a
batch axis of candidate micro-architectures whose per-packet service times
``svc`` differ.  Each is a Python loop over events on ``[B, n_ports]`` port
tensors; it repeats the reference's add/max sequence exactly, so in float64
(absolute form) and float32 (slack form) the results are bitwise equal to
the JAX oracles and to the CUDA kernel in ``kernel.py``.

The CPU tests run these, and ``chip_smoke.py`` holds the kernel against them
on the card.  The dispatching op (``ops.xbar_contend``) takes them only for
tensors that lie on the CPU.

* ``xbar_contend_abs_ref`` carries absolute port-free times and returns
  absolute departure times (float64 on the DSE's path).
* ``xbar_contend_slack_ref`` carries slacks (offsets from the current arrival
  instant) and returns departure offsets, so float32 keeps queueing-delay
  precision on long traces.
"""

from __future__ import annotations

import torch

__all__ = ["xbar_contend_abs_ref", "xbar_contend_slack_ref"]


def xbar_contend_abs_ref(
    t: torch.Tensor,     # [m] float — sorted arrival times, t[0] == 0
    src: torch.Tensor,   # [m] int — source port per packet (shared trace)
    dst: torch.Tensor,   # [m] int — destination port per packet
    svc: torch.Tensor,   # [B, m] float — per-candidate service time per packet
    *,
    n_ports: int,
) -> torch.Tensor:       # [B, m] — absolute departure time per packet
    b, m = svc.shape
    in_f = torch.zeros((b, n_ports), dtype=svc.dtype, device=svc.device)
    out_f = torch.zeros((b, n_ports), dtype=svc.dtype, device=svc.device)
    dep = torch.empty((b, m), dtype=svc.dtype, device=svc.device)
    t = t.to(svc.dtype)
    for k, (i, j) in enumerate(zip(src.tolist(), dst.tolist())):
        start = torch.maximum(torch.maximum(in_f[:, i], out_f[:, j]), t[k])
        end = start + svc[:, k]
        in_f[:, i] = end
        out_f[:, j] = end
        dep[:, k] = end
    return dep


def xbar_contend_slack_ref(
    dt: torch.Tensor,    # [m] float — inter-arrival gaps, dt[0] == 0
    src: torch.Tensor,   # [m] int
    dst: torch.Tensor,   # [m] int
    svc: torch.Tensor,   # [B, m] float
    *,
    n_ports: int,
) -> torch.Tensor:       # [B, m] — departure offsets, as above
    b, m = svc.shape
    in_s = torch.zeros((b, n_ports), dtype=svc.dtype, device=svc.device)
    out_s = torch.zeros((b, n_ports), dtype=svc.dtype, device=svc.device)
    dep = torch.empty((b, m), dtype=svc.dtype, device=svc.device)
    dt = dt.to(svc.dtype)
    for k, (i, j) in enumerate(zip(src.tolist(), dst.tolist())):
        in_s = torch.clamp_min(in_s - dt[k], 0.0)
        out_s = torch.clamp_min(out_s - dt[k], 0.0)
        d = torch.maximum(in_s[:, i], out_s[:, j]) + svc[:, k]
        in_s[:, i] = d
        out_s[:, j] = d
        dep[:, k] = d
    return dep
