"""Admission-gated port-contention replay, plain PyTorch versions.

The stage-4 verifier's recurrence per event k (arrival order) is

    start_k = max(now_k + pipe, in_free[src_k], out_free[dst_k])
    end_k   = start_k + svc_k
    if admit_k: in_free[src_k] = out_free[dst_k] = end_k

These are the counterparts of the JAX package's ``kernels/netsim/ref.py``
oracles and of round 1 (``kernels/netsim/ops.py:_round1_body``), with the
same argument layout.  Each is a Python loop over events on
``[B, n_ports]`` port tensors that repeats the reference's add/max sequence
exactly, so the results are bitwise equal to the JAX oracles (float64) and
to the Pallas tile's slack contract (float32), and to the CUDA kernel in
``kernel.py``.  The CPU tests run them; ``chip_smoke.py`` holds the kernel
against them on the card; ``ops.py`` takes them only for CPU tensors.

* ``netsim_replay_abs_ref``: absolute port-free times, float64, gated.
* ``netsim_replay_slack_ref``: arrival-relative slacks, departure offsets.
* ``round1_ref``: the ungated float64 replay fused with the all-admitted
  fullness check (``fullness_ok``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["netsim_replay_abs_ref", "netsim_replay_slack_ref", "round1_ref",
           "fullness_ok"]


def netsim_replay_abs_ref(
    now: torch.Tensor,    # [m] float — sorted switch-arrival times
    src: torch.Tensor,    # [m] int — source port per event (shared timeline)
    dst: torch.Tensor,    # [m] int — destination port per event
    svc: torch.Tensor,    # [B, m] float — per-candidate service time per event
    pipe: torch.Tensor,   # [B] float — per-candidate pipeline latency
    admit: Optional[torch.Tensor],  # [B, m] bool, or None: every event admitted
    *,
    n_ports: int,
) -> torch.Tensor:        # [B, m] — absolute departure time per event
    b_n, m = svc.shape
    in_f = torch.zeros((b_n, n_ports), dtype=svc.dtype, device=svc.device)
    out_f = torch.zeros((b_n, n_ports), dtype=svc.dtype, device=svc.device)
    end = torch.empty((b_n, m), dtype=svc.dtype, device=svc.device)
    now = now.to(svc.dtype)
    for k, (i, j) in enumerate(zip(src.tolist(), dst.tolist())):
        start = torch.maximum(torch.maximum(now[k] + pipe, in_f[:, i]),
                              out_f[:, j])
        e = start + svc[:, k]
        if admit is None:
            in_f[:, i] = e
            out_f[:, j] = e
        else:
            in_f[:, i] = torch.where(admit[:, k], e, in_f[:, i])
            out_f[:, j] = torch.where(admit[:, k], e, out_f[:, j])
        end[:, k] = e
    return end


def netsim_replay_slack_ref(
    dnow: torch.Tensor,   # [m] float — inter-arrival gaps, dnow[0] == 0
    src: torch.Tensor,    # [m] int
    dst: torch.Tensor,    # [m] int
    svc: torch.Tensor,    # [B, m] float
    pipe: torch.Tensor,   # [B] float
    admit: torch.Tensor,  # [B, m] bool
    *,
    n_ports: int,
) -> torch.Tensor:        # [B, m] — departure offsets (end_k − now_k)
    b_n, m = svc.shape
    in_s = torch.zeros((b_n, n_ports), dtype=svc.dtype, device=svc.device)
    out_s = torch.zeros((b_n, n_ports), dtype=svc.dtype, device=svc.device)
    dep = torch.empty((b_n, m), dtype=svc.dtype, device=svc.device)
    dnow = dnow.to(svc.dtype)
    for k, (i, j) in enumerate(zip(src.tolist(), dst.tolist())):
        in_s = torch.clamp_min(in_s - dnow[k], 0.0)
        out_s = torch.clamp_min(out_s - dnow[k], 0.0)
        d = torch.maximum(torch.maximum(in_s[:, i], out_s[:, j]), pipe) \
            + svc[:, k]
        in_s[:, i] = torch.where(admit[:, k], d, in_s[:, i])
        out_s[:, j] = torch.where(admit[:, k], d, out_s[:, j])
        dep[:, k] = d
    return dep


def fullness_ok(end: torch.Tensor, now: torch.Tensor, depth: torch.Tensor,
                perm: torch.Tensor, seg_start: torch.Tensor,
                rank: torch.Tensor) -> torch.Tensor:
    """Round 1's all-admitted fullness check, ``[B]`` bool.

    With every event admitted, the ``rank − depth``-th event of my chain
    *is* the depth-ago admission, so one gather through the chain
    permutation answers "was my VOQ full when I arrived?" for the whole
    batch; a row is its own fixed point iff no event finds its queue full.
    Runs on ``end``'s device (plain tensor ops after the replay)."""
    m = end.shape[1]
    perm = perm.long()
    e_s = end[:, perm]
    n_s = now[perm]
    r = rank[None, :].long() - depth[:, None].long()
    look = torch.clamp(seg_start[None, :].long() + r, 0, max(m - 1, 0))
    oldest = torch.gather(e_s, 1, look)
    full = (r >= 0) & (oldest > n_s[None, :])
    return ~torch.any(full, dim=1)


def round1_ref(now, src, dst, svc, pipe, depth, perm, seg_start, rank, *,
               n_ports: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused first round: ungated replay + all-admitted fullness check.

    ``svc`` is [B, m]; returns ``(end [B, m], ok [B])``."""
    end = netsim_replay_abs_ref(now, src, dst, svc, pipe, None,
                                n_ports=n_ports)
    return end, fullness_ok(end, now, depth, perm, seg_start, rank)
