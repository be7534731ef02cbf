"""Forward tables (§III-B.2): FullLookup array and Multi-Bank Hash table.

Both variants keep address→port mappings, learn the source address on every
arrival, and answer multi-port lookups in parallel (the FPGA design fully
partitions the array / banks the hash table so every port hits memory in the
same cycle).  A lookup miss yields ``BROADCAST`` (-2).

PyTorch port of the JAX package's ``switch/forward_table.py``.  Keys are
int64 tensors holding uint32 values (PyTorch has no shift or remainder on
uint32), and the multiplicative hash is masked to 32 bits so it wraps as
the reference's uint32 product does.  Ports are int64 (the reference's
int32 values; int64 spares the casts PyTorch indexing would need).  Nothing
here reads a device value on the host: the switch calls these once per
simulated cycle.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Union

import torch

from repro_torch.core.archspec import ForwardTableKind, SwitchArch

__all__ = ["BROADCAST", "FullLookupState", "MultiBankState", "init_table", "lookup", "learn"]

BROADCAST = -2
_EMPTY = -1
_U32 = 0xFFFFFFFF


class FullLookupState(NamedTuple):
    ports: torch.Tensor  # [2^addr_bits + 1] int64, -1 = unknown; the last
    #                      entry absorbs the writes of invalid lanes


class MultiBankState(NamedTuple):
    keys: torch.Tensor    # [banks, depth] int64 holding uint32 keys
    ports: torch.Tensor   # [banks, depth] int64, -1 = empty
    mults: torch.Tensor   # [banks] int64 per-bank hash multipliers


TableState = Union[FullLookupState, MultiBankState]

# Knuth-style odd multipliers (distinct per bank → near-independent hashes)
_HASH_MULTS = (2654435761, 2246822519, 3266489917, 668265263, 374761393, 2869860233, 3624381081, 961748927)


def init_table(arch: SwitchArch, device=None) -> TableState:
    if arch.fwd is ForwardTableKind.FULL_LOOKUP:
        return FullLookupState(ports=torch.full(((1 << arch.addr_bits) + 1,), _EMPTY,
                                                dtype=torch.int64, device=device))
    mults = torch.tensor([_HASH_MULTS[b % len(_HASH_MULTS)] for b in range(arch.hash_banks)],
                         dtype=torch.int64, device=device)
    return MultiBankState(
        keys=torch.zeros((arch.hash_banks, arch.hash_depth), dtype=torch.int64, device=device),
        ports=torch.full((arch.hash_banks, arch.hash_depth), _EMPTY, dtype=torch.int64,
                         device=device),
        mults=mults,
    )


def _bank_slots(state: MultiBankState, key: torch.Tensor) -> torch.Tensor:
    """Per-bank slot index for a key [..., banks] (multiplicative hashing;
    the product keeps its low 32 bits, as uint32 arithmetic does)."""
    depth = state.keys.shape[1]
    h = (key[..., None] * state.mults) & _U32                  # [..., banks]
    return (h >> 16) % depth


def lookup(arch: SwitchArch, state: TableState, dst_key: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """Parallel multi-port lookup.  dst_key [P] -> out_port [P] int64.

    Returns BROADCAST (-2) on miss, -1 for invalid lanes.
    """
    if arch.fwd is ForwardTableKind.FULL_LOOKUP:
        port = state.ports[dst_key & ((1 << arch.addr_bits) - 1)]
    else:
        banks, depth = state.keys.shape
        slots = _bank_slots(state, dst_key)                        # [P, B]
        flat = slots + torch.arange(banks, device=slots.device) * depth
        keys = state.keys.reshape(-1)[flat]                        # [P, B]
        ports = state.ports.reshape(-1)[flat]                      # [P, B]
        hit = (keys == dst_key[:, None]) & (ports != _EMPTY)
        first = hit.to(torch.int8).argmax(-1, keepdim=True)        # first hit bank
        port = torch.where(hit.any(-1), ports.gather(1, first)[:, 0], _EMPTY)
    port = torch.where(port == _EMPTY, BROADCAST, port)
    return torch.where(valid, port, _EMPTY)


@functools.lru_cache(maxsize=None)
def _later_lanes(n: int, device) -> torch.Tensor:
    """[n, n] bool: lane j comes after lane i."""
    lane = torch.arange(n, device=device)
    return lane[None, :] > lane[:, None]


def learn(arch: SwitchArch, state: TableState, src_key: torch.Tensor,
          in_port: torch.Tensor, valid: torch.Tensor) -> TableState:
    """Learn src→port on every arrival (parallel across ports).

    MultiBank insert: first bank whose slot is free or already holds the key;
    if every bank slot is occupied by a different key, evict in bank 0 — the
    conflict behaviour the DSE's II penalty models.  Updates the state's
    tensors in place and returns the state.
    """
    if arch.fwd is ForwardTableKind.FULL_LOOKUP:
        size = state.ports.shape[0] - 1
        idx = src_key & ((1 << arch.addr_bits) - 1)
        # two lanes learning one address in a cycle: the last lane wins, as
        # in the reference's in-order scatter; the others, and invalid
        # lanes, write the spare last entry (aliasing a real index would
        # clobber concurrently-learned entries)
        later = (idx[:, None] == idx[None, :]) & valid[None, :] \
            & _later_lanes(idx.shape[0], idx.device)
        idx = torch.where(valid & ~later.any(1), idx, size)
        state.ports.index_put_((idx,), in_port.to(torch.int64))
        return state

    # sequential over ports, as the reference's scan: a later port sees the
    # earlier ports' inserts in the same cycle
    banks, depth = state.keys.shape
    keys, ports = state.keys.reshape(-1), state.ports.reshape(-1)
    base = torch.arange(banks, device=keys.device) * depth
    all_slots = _bank_slots(state, src_key) + base                 # [P, B]
    for p in range(src_key.shape[0]):
        key, flat = src_key[p:p + 1], all_slots[p]
        free_or_same = (ports[flat] == _EMPTY) | (keys[flat] == key)
        bank = free_or_same.to(torch.int8).argmax(0, keepdim=True)  # 0 if none: evict
        slot = flat.gather(0, bank)
        ok = valid[p:p + 1]
        keys.index_put_((slot,), torch.where(ok, key, keys[slot]))
        ports.index_put_((slot,), torch.where(ok, in_port[p:p + 1].to(torch.int64),
                                              ports[slot]))
    return state
