"""Schedulers (§III-B.4): Round-Robin, iSLIP, EDRRM — bit-matrix matching.

All three compute a one-to-one matching between input and output ports from
the VOQ occupancy matrix, as tensor code on [N, N] boolean matrices so the
whole switch steps one cycle at a time without reading the device:

* **RR** — single request/grant/accept round with rotating priorities that
  always advance (the classic desynchronisation weakness is retained on
  purpose; it is why RR under-performs on uniform traffic in Fig. 1).
* **iSLIP** — ``islip_iters`` request/grant/accept iterations; grant/accept
  pointers move only on a first-iteration accepted grant (McKeown's rule),
  which desynchronises outputs and approaches 100% uniform throughput.  In
  this eager step it runs through ``repro_torch.kernels.islip`` with a batch
  of one.  On a card ``simulate`` runs all three schedulers inside the fused
  cycle loop (``repro_torch.kernels.switch_loop``); this module is that
  loop's plain version on the CPU.
* **EDRRM** — dual round-robin request/grant with *exhaustive service*: a
  matched (input, output) pair is held as long as the queue stays non-empty,
  amortising arbitration across a burst (why it wins on bursty traffic).

PyTorch port of the JAX package's ``switch/scheduler.py``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.archspec import SchedulerKind, SwitchArch
from repro_torch.kernels.islip import islip_schedule

__all__ = ["SchedState", "init_sched", "schedule", "release_exhausted"]


class SchedState(NamedTuple):
    grant_ptr: torch.Tensor   # [N] int32 output-side rotating pointers
    accept_ptr: torch.Tensor  # [N] int32 input-side rotating pointers (iSLIP accept / EDRRM request)
    held: torch.Tensor        # [N] int32 EDRRM: output currently held by each input (-1 = none)


def init_sched(arch: SwitchArch, device=None) -> SchedState:
    n = arch.n_ports
    z = torch.zeros((n,), dtype=torch.int32, device=device)
    return SchedState(grant_ptr=z, accept_ptr=z,
                      held=torch.full((n,), -1, dtype=torch.int32, device=device))


@functools.lru_cache(maxsize=None)
def _tables(n: int, device):
    """Port ids as a row; rank[p, i] = (i - p) mod n, the rotating priority
    of i under pointer p; nxt[i] = (i + 1) mod n, the pointer one past i."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    rank = (idx[None, :] - idx[:, None]) % n
    return idx[None, :], rank, ((idx + 1) % n).to(torch.int32)


def _pick_rows(v: torch.Tensor, p: torch.Tensor):
    """Each input row of v [N, N] (bool) picks its first set bit at/after
    the row's rotating pointer p [N] (0 <= p < N, as the scheduler keeps
    them).  Returns (one-hot [N, N], picked index [N], row had a set bit [N])."""
    n = v.shape[-1]
    idx, rank, _ = _tables(n, v.device)
    sel = torch.where(v, rank[p], n + 1).argmin(-1)
    has = v.any(-1)
    return (idx == sel[:, None]) & has[:, None], sel, has


def _pick_cols(v: torch.Tensor, p: torch.Tensor):
    """Each output column picks one row."""
    onehot, sel, has = _pick_rows(v.t(), p)
    return onehot.t(), sel, has


def _rr(arch: SwitchArch, st: SchedState, req: torch.Tensor) -> Tuple[torch.Tensor, SchedState]:
    nxt = _tables(arch.n_ports, req.device)[2]
    # each output grants one input (g_in), each input accepts one grant (a_out)
    grants, g_in, granted = _pick_cols(req, st.grant_ptr)
    match, a_out, accepted = _pick_rows(grants, st.accept_ptr)
    new_g = torch.where(granted, nxt[g_in], st.grant_ptr)
    new_a = torch.where(accepted, nxt[a_out], st.accept_ptr)
    return match, SchedState(new_g, new_a, st.held)


def _islip(arch: SwitchArch, st: SchedState, req: torch.Tensor) -> Tuple[torch.Tensor, SchedState]:
    match, gptr, aptr = islip_schedule(req[None].to(torch.int32), st.grant_ptr[None],
                                       st.accept_ptr[None], iters=arch.islip_iters)
    return match[0] != 0, SchedState(gptr[0], aptr[0], st.held)


def _edrrm(arch: SwitchArch, st: SchedState, req: torch.Tensor) -> Tuple[torch.Tensor, SchedState]:
    n = arch.n_ports
    idx, _, nxt = _tables(n, req.device)
    # --- request phase: one request per input; held output has priority
    held_valid = (st.held >= 0) & req.gather(1, torch.clamp(st.held, min=0)[:, None].long())[:, 0]
    _, fresh_out, fresh_any = _pick_rows(req, st.accept_ptr)
    req_out = torch.where(held_valid, st.held.long(), torch.where(fresh_any, fresh_out, -1))
    rq = (req_out[:, None] == idx) & (req_out >= 0)[:, None]           # [N,N]
    # --- grant phase: held input has priority at its output, else rotating pick
    held_req = rq & held_valid[:, None]                          # held continuations
    grants_held, _, _ = _pick_cols(held_req, st.grant_ptr)       # at most one per output
    remaining = rq & ~grants_held.any(0)[None, :]
    grants_new, g_in, new_grant = _pick_cols(remaining, st.grant_ptr)
    match = grants_held | grants_new
    # --- exhaustive-service state: hold matched pairs (release handled by caller
    # via occupancy-after; here hold optimistically, caller clears empties)
    matched = match.any(1)
    new_held = torch.where(matched, match.to(torch.int8).argmax(1), -1).to(torch.int32)
    new_g = torch.where(new_grant, nxt[g_in], st.grant_ptr)
    fresh_used = matched & ~held_valid
    new_a = torch.where(fresh_used, nxt[torch.clamp(req_out, min=0)], st.accept_ptr)
    return match, SchedState(new_g, new_a, new_held)


def schedule(
    arch: SwitchArch,
    st: SchedState,
    occupancy: torch.Tensor,   # [N, N] int queue counts
    busy_in: torch.Tensor,     # [N] bool — mid multi-flit transfer
    busy_out: torch.Tensor,    # [N] bool
) -> Tuple[torch.Tensor, SchedState]:
    req = (occupancy > 0) & ~(busy_in[:, None] | busy_out[None, :])
    if arch.sched is SchedulerKind.RR:
        return _rr(arch, st, req)
    if arch.sched is SchedulerKind.ISLIP:
        return _islip(arch, st, req)
    return _edrrm(arch, st, req)


def release_exhausted(st: SchedState, match: torch.Tensor, occ_after: torch.Tensor) -> SchedState:
    """EDRRM: drop the hold when the matched queue just emptied."""
    out = torch.clamp(st.held, min=0).long()
    empty = occ_after.gather(1, out[:, None])[:, 0] <= 0
    new_held = torch.where((st.held >= 0) & empty, -1, st.held)
    return st._replace(held=new_held)
