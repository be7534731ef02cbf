"""The ring-scan stage-4 engine, plain PyTorch version.

The counterpart of the JAX package's ``sim/batched_netsim.py:
_verify_engine_impl`` (the float64 ``lax.scan`` that ``use_kernel="off"``
selects), with the same arguments.  Per event k of the shared, time-sorted
timeline and per candidate row, with ``q = src[k] * n_ports + dst[k]``:

    tq     = tail[q]
    oldest = ring[q, tq % mod]           # the departure `depth` admissions ago
    full   = tq >= depth and oldest > now[k]
    end    = max(max(now[k] + pipe, in_free[src]), out_free[dst]) + svc[k]
    if not full: in_free[src] = out_free[dst] = ring[q, tq % mod] = end,
                 tail[q] += 1

It is a Python loop over events on ``[B]`` tensors that repeats the
reference's operations in its order, so ``end`` and ``admit`` are bitwise
the reference's.  ``ops.ring_scan`` takes it for CPU tensors; the CUDA
kernel (``kernel.py``) is held against it on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["ring_scan_ref"]


def ring_scan_ref(
    now: torch.Tensor,    # [m] float64 — sorted switch-arrival times
    src: torch.Tensor,    # [m] int — source port per event
    dst: torch.Tensor,    # [m] int — destination port per event
    svc: torch.Tensor,    # [B, m] float64 — service time per row and event
    pipe: torch.Tensor,   # [B] float64 — pipeline latency per row
    depth: torch.Tensor,  # [B] int — VOQ depth per row
    mod: torch.Tensor,    # [B] int — ring modulus, min(max(depth, 1), m)
    *,
    n_ports: int,
    d_max: int,
) -> Tuple[torch.Tensor, torch.Tensor]:   # end [B, m] float64, admit [B, m] bool
    b_n, m = svc.shape
    dev = svc.device
    in_f = torch.zeros((b_n, n_ports), dtype=svc.dtype, device=dev)
    out_f = torch.zeros((b_n, n_ports), dtype=svc.dtype, device=dev)
    ring = torch.zeros((b_n, n_ports * n_ports, d_max), dtype=svc.dtype,
                       device=dev)
    tail = torch.zeros((b_n, n_ports * n_ports), dtype=torch.int64, device=dev)
    end = torch.empty((b_n, m), dtype=svc.dtype, device=dev)
    admit = torch.empty((b_n, m), dtype=torch.bool, device=dev)
    brange = torch.arange(b_n, device=dev)
    depth = depth.to(torch.int64)
    mod = mod.to(torch.int64)
    now = now.to(svc.dtype)
    tp = now[:, None] + pipe[None, :]        # [m, B]: the reference's t + pipe
    for k, (i, j) in enumerate(zip(src.tolist(), dst.tolist())):
        q = i * n_ports + j
        tq = tail[:, q]
        slot = tq % mod
        oldest = ring[brange, q, slot]
        ad = ~((tq >= depth) & (oldest > now[k]))
        e = torch.maximum(torch.maximum(tp[k], in_f[:, i]), out_f[:, j]) \
            + svc[:, k]
        in_f[:, i] = torch.where(ad, e, in_f[:, i])
        out_f[:, j] = torch.where(ad, e, out_f[:, j])
        ring[brange, q, slot] = torch.where(ad, e, oldest)
        tail[:, q] = tq + ad
        end[:, k] = e
        admit[:, k] = ad
    return end, admit
