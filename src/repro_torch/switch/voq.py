"""Virtual-Output-Queue buffers (§III-B.3): N×N data VOQs and Shared VOQs.

* **N×N** — fully partitioned per-(input, output) data queues; broadcast
  packets are *copied* into every queue of the source (memory duplication,
  the stated drawback), each queue bounded by ``voq_depth``.
* **Shared** — one central data buffer with pointer-based per-(i,j) queues
  and a per-packet reference count (the bitmap of pending destinations):
  broadcast stores payload once and replicates only pointers.  Total data
  capacity is ``n_ports × voq_depth`` slots (vs N²×depth for N×N), which is
  where the BRAM saving comes from; the logic overhead of pointer management
  shows up as +1 pipeline stage in ``SwitchArch.pipeline_depth``.

Queues store packet *ids*; payload width only affects the resource model and
multi-flit timing (handled by the switch's busy counters).

PyTorch port of the JAX package's ``switch/voq.py``: the same state and the
same arithmetic on tensors (int64, holding the reference's int32 values).
``.at[].add`` with repeated indices becomes ``index_add_`` (integer, so the
order of the additions cannot matter), and the ring-buffer write is a
scatter into the flattened queue, whose one spare last entry absorbs the
lanes that store nothing.  The queue and the per-packet refcounts are
updated in place (the switch owns its state, and a refcount array as long
as the trace would otherwise be copied every cycle).  Nothing here reads a
device value on the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.archspec import SwitchArch, VOQKind
from .forward_table import BROADCAST

__all__ = ["VOQState", "init_voq", "occupancy", "enqueue", "dequeue", "queues"]


class VOQState(NamedTuple):
    queue: torch.Tensor       # [N*N*D + 1] packet ids ([N, N, D] flat, + spare)
    head: torch.Tensor        # [N, N]
    tail: torch.Tensor        # [N, N]
    data_slots: torch.Tensor  # scalar: payload slots in use (shared semantics)
    rem_copies: torch.Tensor  # [n_packets] pending copies (shared refcount)
    drops: torch.Tensor       # scalar dropped copies


def init_voq(arch: SwitchArch, n_packets: int, device=None) -> VOQState:
    n, d = arch.n_ports, arch.voq_depth
    z = lambda *s: torch.zeros(s, dtype=torch.int64, device=device)  # noqa: E731
    return VOQState(
        queue=torch.full((n * n * d + 1,), -1, dtype=torch.int64, device=device),
        head=z(n, n),
        tail=z(n, n),
        data_slots=z(),
        rem_copies=z(max(n_packets, 1)),
        drops=z(),
    )


def queues(arch: SwitchArch, st: VOQState) -> torch.Tensor:
    """The queue contents as the reference's [N, N, D] array."""
    n, d = arch.n_ports, arch.voq_depth
    return st.queue[:n * n * d].reshape(n, n, d)


def shared_capacity(arch: SwitchArch) -> int:
    return arch.n_ports * arch.voq_depth


def occupancy(st: VOQState) -> torch.Tensor:
    return st.tail - st.head


@functools.lru_cache(maxsize=None)
def _consts(n: int, d: int, device):
    """Per-shape constants: port ids as a row and as a column, the
    broadcast fan-out (everyone but the source), and each queue's first slot
    in the flat buffer, (i * N + j) * D."""
    ports = torch.arange(n, dtype=torch.int64, device=device)
    others = ports[None, :] != ports[:, None]
    base = (torch.arange(n * n, dtype=torch.int64, device=device) * d).reshape(n, n)
    return ports[None, :], ports[:, None], others, base


def enqueue(
    arch: SwitchArch,
    st: VOQState,
    pids: torch.Tensor,       # [N] arriving packet id per input port (-1 none)
    out_ports: torch.Tensor,  # [N] destination port, BROADCAST, or -1 invalid
    valid: torch.Tensor,      # [N] bool
) -> VOQState:
    n, d = arch.n_ports, arch.voq_depth
    row, _, others, base = _consts(n, d, pids.device)
    # fanout matrix: unicast one-hot, broadcast = everyone but the source
    dest = out_ports[:, None]
    fan = ((dest == row) | ((dest == BROADCAST) & others)) & valid[:, None]  # [N,N]
    room = occupancy(st) < d
    data_slots, drops = st.data_slots, st.drops
    if arch.voq is VOQKind.SHARED:
        # shared data buffer admission: packets admitted in port order until full
        wants = fan.any(1)
        admit = wants & (data_slots + torch.cumsum(wants, 0) <= shared_capacity(arch))
        fan = fan & admit[:, None]
        drops = drops + (wants.sum() - admit.sum())      # refused whole packets
    store = fan & room                                                     # [N,N]
    n_store = store.sum()
    drops = drops + (fan.sum() - n_store)                # copies with no room
    # ring-buffer write at tail (lanes that store nothing hit the spare entry)
    flat = torch.where(store, base + st.tail % d, n * n * d)
    st.queue.index_put_((flat,), pids[:, None])
    tail = st.tail + store
    # refcounts / data slot accounting
    copies = torch.where(valid, store.sum(1), 0)                           # per input
    rem = st.rem_copies.index_add_(0, torch.clamp(pids, min=0), copies)
    if arch.voq is VOQKind.SHARED:
        data_slots = data_slots + store.any(1).sum()                       # one slot per packet
    else:
        data_slots = data_slots + n_store                                  # one per copy
    return VOQState(st.queue, st.head, tail, data_slots, rem, drops)


def dequeue(
    arch: SwitchArch,
    st: VOQState,
    match: torch.Tensor,     # [N, N] bool accepted matching
) -> Tuple[VOQState, torch.Tensor, torch.Tensor]:
    """Pop matched heads. Returns (state, dep_pid[N_out], dep_in[N_out])."""
    n, d = arch.n_ports, arch.voq_depth
    _, col, _, base = _consts(n, d, match.device)
    heads = st.queue[base + st.head % d]                                   # [N,N]
    popped_one = match.to(torch.int64)
    head = st.head + popped_one
    dep_pid = torch.where(match, heads, -1).amax(0)       # one match per column
    dep_in = torch.where(match, col, -1).amax(0)
    # refcount update
    popped = torch.clamp(torch.where(match, heads, 0), min=0)
    rem = st.rem_copies.index_add_(0, popped.reshape(-1), popped_one.reshape(-1), alpha=-1)
    if arch.voq is VOQKind.SHARED:
        # free the data slot only when the last pending copy leaves
        freed = (match & (rem[torch.clamp(heads, min=0)] <= 0)).sum()
    else:
        freed = match.sum()
    return (VOQState(st.queue, head, st.tail, st.data_slots - freed, rem, st.drops),
            dep_pid, dep_in)
