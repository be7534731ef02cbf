"""Dispatch + segmented-chain machinery for the netsim kernel family.

The stage-4 finite-VOQ recurrence looks inherently serial: every event's
admission depends on the departure ring of its (src, dst) VOQ, and every
departure depends on shared port state.  The kernels family splits those two
couplings and conquers each with the structure it actually has:

* **Port coupling** (departure times) keeps a scan, but a *lean* one — the
  admission-gated port replay, with no ``[B, N², D]`` ring.  On a CUDA
  device it is the hand-written kernel (``kernel.netsim_replay``); on the
  CPU its plain PyTorch version (``ref.py``).
* **VOQ coupling** (admission flags) is *per-chain*: whether event k of
  chain (i, j) is dropped depends only on earlier events of the same chain.
  Inside a chain, admitted departures are FIFO (shared input and output
  port), so "the queue holds ``depth`` undeparted packets at ``now_k``" is
  exactly "the admission ``depth`` slots ago has not departed" — a
  segmented-scan question answered for **all events of all candidates at
  once** by ``segmented_admission`` (one segmented cumsum + one gather over
  the chain-sorted timeline, no replay).  These passes stay on the host, as
  in the JAX package; ``segmented_admission`` is its copy, and
  ``segmented_occupancy`` replaces its composite float key with an exact
  per-chain search (see there).

The two halves meet in ``netsim_fixed_point``: speculate all-admitted, replay,
re-derive admissions, repeat.  Why the fixed point is the serial solution:
order events by arrival; event k's departure depends only on flags of events
< k, and event k's admission flag depends only on departures of its chain's
events < k.  By induction over k, any self-consistent (flags, departures)
pair equals the serial replay's — so when the loop closes, the result is
*exact*, not approximate (drop decisions bitwise).
In the common no-drop regime round 1 already closes; only rows that dropped
something iterate further, and a row that fails to close in ``max_rounds``
is reported unconverged so the caller can fall back to the serial oracle.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.retrace import track

from . import kernel
from .ref import fullness_ok, netsim_replay_abs_ref, netsim_replay_slack_ref

__all__ = [
    "ChainIndex", "build_chain_index", "segmented_admission",
    "segmented_occupancy", "lean_replay", "netsim_fixed_point",
    "kernel_available", "resolve_use_kernel",
]


def kernel_available() -> bool:
    """Whether ``use_kernel="auto"`` resolves to the kernel path.

    An environment kill-switch, not a capability probe, as in the JAX
    package: ``SPAC_NETSIM_KERNEL=off`` selects the ring-scan engine
    (``repro_torch.kernels.ring_scan``)."""
    return os.environ.get("SPAC_NETSIM_KERNEL", "").lower() not in {
        "0", "off", "false", "no"}


def resolve_use_kernel(value) -> bool:
    """Normalise the ``use_kernel`` knob: True/"on", False/"off", "auto"."""
    if isinstance(value, bool):
        return value
    if value is None:
        return kernel_available()
    v = str(value).lower()
    if v in {"on", "true", "1", "yes"}:
        return True
    if v in {"off", "false", "0", "no"}:
        return False
    if v == "auto":
        return kernel_available()
    raise ValueError(f"use_kernel must be 'auto', 'on'/'off' or a bool, "
                     f"got {value!r}")


# --------------------------------------------------------------------------
# chain index: the segmented view of the shared timeline
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChainIndex:
    """Per-(src,dst) chain structure of one time-ordered event timeline.

    ``perm`` stably sorts events by chain id (time order preserved inside a
    chain), ``inv`` undoes it, ``seg_start[p]``/``rank[p]`` give, for the
    event at *permuted* position p, its chain's first permuted position and
    its arrival rank within the chain.  Pure function of (timeline, n_ports)
    — computed once per trace by ``sim.timeline`` and reused across every
    generation, candidate and campaign scenario."""

    perm: np.ndarray        # [m] intp — stable argsort of chain ids
    inv: np.ndarray         # [m] intp — inverse permutation
    seg_start: np.ndarray   # [m] int32 — chain block start, permuted domain
    rank: np.ndarray        # [m] int32 — arrivals-before-me within my chain
    n_chains: int


def build_chain_index(qid: np.ndarray) -> ChainIndex:
    m = qid.size
    perm = np.argsort(qid, kind="stable")
    g = qid[perm]
    first = np.ones(m, bool)
    first[1:] = g[1:] != g[:-1]
    starts = np.nonzero(first)[0]
    run_ids = np.cumsum(first) - 1
    seg_start = starts[run_ids].astype(np.int32) if m else np.zeros(0, np.int32)
    rank = (np.arange(m, dtype=np.int32) - seg_start).astype(np.int32)
    inv = np.empty(m, np.intp)
    inv[perm] = np.arange(m)
    return ChainIndex(perm=perm.astype(np.intp), inv=inv, seg_start=seg_start,
                      rank=rank, n_chains=int(starts.size))


# --------------------------------------------------------------------------
# segmented admission: finite-VOQ fullness without replay
# --------------------------------------------------------------------------

def segmented_admission(end: np.ndarray, admit: np.ndarray, now: np.ndarray,
                        depth: np.ndarray, chain: ChainIndex) -> np.ndarray:
    """Derive next-round admission flags from a candidate replay.

    Given departure times ``end`` produced under speculative flags ``admit``,
    answer for every event of every candidate: *with these departures, would
    my VOQ have been full when I arrived?*  FIFO-per-chain makes that "has
    the admission ``depth`` slots before me departed by ``now``" — a
    segmented cumulative count (``na`` = admissions before me in my chain)
    plus one gather into a compacted per-chain admission array.  All numpy,
    no scan: one pass covers the whole [B, m] block.
    """
    b_n, m = end.shape
    perm, seg_start = chain.perm, chain.seg_start
    a_s = admit[:, perm]
    e_s = end[:, perm]
    n_s = now[perm]
    cum = np.cumsum(a_s, axis=1, dtype=np.int32)
    excl = cum - a_s                                    # admits before me, global
    na = excl - np.take(excl, seg_start, axis=1)        # ... within my chain
    # compact admitted departure times to their admission-rank slots; dropped
    # events park in the spare column m (never read: full needs na >= depth,
    # and that rank's slot was written by a real admission)
    slot = np.where(a_s, seg_start + na, m)
    comp = np.zeros((b_n, m + 1))
    rows = np.arange(b_n, dtype=np.intp)[:, None] * (m + 1)
    comp.ravel()[(slot + rows).ravel()] = e_s.ravel()
    r = na - depth[:, None].astype(np.int32)
    look = np.where(r >= 0, seg_start + r, m)
    oldest = np.take(comp.ravel(), (look + rows).ravel()).reshape(b_n, m)
    full = (r >= 0) & (oldest > n_s[None, :])
    return (~full)[:, chain.inv]


# --------------------------------------------------------------------------
# segmented occupancy: stage 2's per-VOQ counts without the per-row loop
# --------------------------------------------------------------------------

def segmented_occupancy(t: np.ndarray, dep: np.ndarray,
                        chain: ChainIndex) -> np.ndarray:
    """Exact per-VOQ occupancy at arrival instants, one search per chain.

    Occupancy at event k is ``(chain arrivals before k) − (chain departures
    ≤ now_k)`` — a prefix count inside k's chain segment.  Departures are
    FIFO inside a chain (shared ports), so each row's chain block of ``dep``
    is sorted and one batched ``torch.searchsorted`` per chain answers every
    (candidate, event) query of that chain, comparing the raw float64 times.

    This departs from the JAX package's version, which folds (row, chain,
    time) into one float64 key for a single flat ``np.searchsorted``: that
    key spends mantissa bits on the row and chain offset (its magnitude
    grows as B·m·span), so on long traces distinct times collide and counts
    drift from the serial model (a 372k-event hft capture at B = 48 miscounts
    about one event in two thousand).  Here the counts are the serial
    model's at any length; on the registry traces, where the reference's key
    is still fine enough, the two agree exactly."""
    b_n, m = dep.shape
    perm = chain.perm
    dep_s = np.ascontiguousarray(dep[:, perm])
    t_s = np.ascontiguousarray(t[perm], dtype=np.float64)
    departed = np.empty((b_n, m), np.int64)
    bounds = np.append(np.unique(chain.seg_start), m)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        d = torch.from_numpy(np.ascontiguousarray(dep_s[:, lo:hi]))
        a = torch.from_numpy(t_s[lo:hi]).expand(b_n, hi - lo).contiguous()
        departed[:, lo:hi] = torch.searchsorted(d, a, right=True).numpy()
    occ_s = chain.rank[None, :].astype(np.int64) - departed
    return occ_s[:, chain.inv]


# --------------------------------------------------------------------------
# the lean replay: CUDA kernel on the card, plain version on the CPU
# --------------------------------------------------------------------------

def _replay(now, src, dst, svc, pipe, admit, *, n_ports: int):
    """Float64 replay of ``svc``'s device: ``admit`` [B, m] bool or None
    (round 1: every event admitted).  Returns absolute end times [B, m]."""
    if svc.device.type == "cpu":
        return netsim_replay_abs_ref(now, src, dst, svc, pipe, admit,
                                     n_ports=n_ports)
    admit_t = None if admit is None else admit.t().to(torch.uint8).contiguous()
    return kernel.netsim_replay(now, src.to(torch.int32), dst.to(torch.int32),
                                svc.t().contiguous(), pipe, admit_t,
                                n_ports=n_ports, absolute=True)


def lean_replay(now, src, dst, svc, pipe, admit, *, n_ports: int,
                precision: str = "float64"):
    """The admission-gated lean replay on ``svc``'s device.

    ``now``/``src``/``dst`` [m], ``svc``/``admit`` [B, m], ``pipe`` [B], all
    tensors on one device.  ``precision="float64"`` (default): absolute
    departure times, bit-exact against the serial model.
    ``precision="float32"``: the slack form the Pallas tile implements,
    returning departure *offsets* (``end − now``); the port's counterpart of
    the JAX package's ``use_pallas=True``."""
    admit = admit.to(torch.bool)
    if precision == "float64":
        return _replay(now.to(torch.float64), src, dst, svc.to(torch.float64),
                       pipe.to(torch.float64), admit, n_ports=n_ports)
    if precision != "float32":
        raise ValueError(f"precision must be 'float64' or 'float32', "
                         f"got {precision!r}")
    now64 = now.to(torch.float64)
    dnow = torch.diff(now64, prepend=now64.new_zeros(1)).to(torch.float32)
    svc32, pipe32 = svc.to(torch.float32), pipe.to(torch.float32)
    if svc.device.type == "cpu":
        return netsim_replay_slack_ref(dnow, src, dst, svc32, pipe32, admit,
                                       n_ports=n_ports)
    return kernel.netsim_replay(
        dnow, src.to(torch.int32), dst.to(torch.int32), svc32.t().contiguous(),
        pipe32, admit.t().to(torch.uint8).contiguous(), n_ports=n_ports,
        absolute=False)


def _round1_impl(now, src, dst, svc, pipe, depth, perm, seg_start, rank, *,
                 n_ports: int):
    """Round 1 of the fixed point: the ungated replay and its all-admitted
    fullness check, ``(end [B, m], ok [B])`` on ``svc``'s device."""
    end = _replay(now, src, dst, svc, pipe, None, n_ports=n_ports)
    return end, fullness_ok(end, now, depth, perm, seg_start, rank)


# tracked under the JAX package's names for its jitted round 1 and replay
_round1 = track("netsim.kernel.round1", _round1_impl,
                static_argnames=("n_ports",))
_gated_replay = track("netsim.kernel.replay", _replay,
                      static_argnames=("n_ports",))


def _on(a, dtype, device) -> torch.Tensor:
    """Host array -> a fresh tensor on ``device`` (the timeline memo's
    arrays are read-only and shared, so they are copied, never aliased)."""
    return torch.tensor(np.asarray(a, dtype), device=device)


def _pad_rows(a: np.ndarray, size: int) -> np.ndarray:
    """Pad the candidate axis to ``size`` by replicating row 0 (a no-op
    workload: rowwise engines ignore replicas, callers strip them)."""
    if a.shape[0] == size:
        return a
    reps = np.repeat(a[:1], size - a.shape[0], axis=0)
    return np.concatenate([a, reps], axis=0)


def _bucket(b_n: int) -> int:
    """Row bucket of the subset rounds: the next power of two, as in the
    JAX package (where it bounds recompiles; here it keeps the launch
    shapes of a run to O(log B))."""
    return 1 << max(b_n - 1, 0).bit_length()


def netsim_fixed_point(
    now: np.ndarray,       # [m] sorted switch-arrival times
    src: np.ndarray,       # [m] int32
    dst: np.ndarray,       # [m] int32
    svc: np.ndarray,       # [B, m] float64
    pipe: np.ndarray,      # [B] float64
    depth: np.ndarray,     # [B] int — per-candidate VOQ depth (>= 1)
    *,
    n_ports: int,
    chain: ChainIndex,
    device: torch.device,
    max_rounds: int = 24,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Speculative fixed point: (end [B,m], admit [B,m], converged [B], rounds).

    Round 1 runs the ungated replay plus the fullness check for the whole
    batch on ``device`` (the CUDA kernel, then plain tensor ops).  Rows
    whose all-admitted replay is already self-consistent — every row, when
    stage-3 sizing did its job — are final.  The rest iterate gated replay
    ↔ ``segmented_admission`` (host NumPy) on the row subset only, padded
    to a power-of-two bucket; unconverged rows after ``max_rounds`` are
    flagged for the caller's serial fallback.  Callers must handle
    ``depth < 1`` rows themselves (serial semantics drop every packet; no
    replay needed)."""
    b_n, m = svc.shape
    if np.any(depth < 1):
        raise ValueError("netsim_fixed_point requires depth >= 1 rows")
    depth32 = np.minimum(depth, np.int64(2**31 - 1)).astype(np.int32)

    now_d = _on(now, np.float64, device)
    src_d = _on(src, np.int32, device)
    dst_d = _on(dst, np.int32, device)
    svc_d = _on(svc, np.float64, device)
    pipe_d = _on(pipe, np.float64, device)
    end_d, ok_d = _round1(
        now_d, src_d, dst_d, svc_d, pipe_d, _on(depth32, np.int32, device),
        _on(chain.perm, np.int64, device), _on(chain.seg_start, np.int32, device),
        _on(chain.rank, np.int32, device), n_ports=n_ports)
    end = end_d.cpu().numpy()
    ok = ok_d.cpu().numpy()
    del svc_d, end_d
    admit = np.ones((b_n, m), bool)
    converged = ok.copy()
    if bool(ok.all()):
        return end, admit, converged, 1

    rows = np.nonzero(~ok)[0]
    sub_svc, sub_pipe = svc[rows], pipe[rows]
    sub_depth = depth32[rows]
    sub_end = end[rows]
    cur = segmented_admission(sub_end, np.ones((rows.size, m), bool), now,
                              sub_depth, chain)
    rounds = 1
    conv_sub = np.zeros(rows.size, bool)
    while rounds < max_rounds:
        rounds += 1
        size = _bucket(rows.size)
        sub_end = _gated_replay(
            now_d, src_d, dst_d, _on(_pad_rows(sub_svc, size), np.float64, device),
            _on(_pad_rows(sub_pipe, size), np.float64, device),
            _on(_pad_rows(cur, size), np.bool_, device),
            n_ports=n_ports)[:rows.size].cpu().numpy()
        derived = segmented_admission(sub_end, cur, now, sub_depth, chain)
        eq = (derived == cur).all(axis=1)
        conv_sub = np.asarray(eq)
        if bool(eq.all()):
            break
        cur = derived
    end[rows] = sub_end
    admit[rows] = cur
    converged[rows] = conv_sub
    return end, admit, converged, rounds
