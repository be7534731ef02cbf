"""Architecture configuration space (§III-A "Architecture Configuration").

Users declare architectural *policies* — forwarding structure, VOQ
organisation, scheduler, bus width, buffer depth — either as explicit values
or as ``AUTO``, in which case the DSE engine (core/dse.py) infers the optimal
micro-architecture from trace characteristics.

The same dataclasses double as Algorithm 1's "Templates A": a concrete
``SwitchArch`` carries its initiation interval and pipeline depth, which
stage 1 uses for static timing pruning.

Custom in-network kernels (§III-B.5) are injected via ``CustomKernelSpec``,
which carries the paper's *performance interface* (latency and resource
boundaries) so the kernel participates in the DSE loop.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Callable, List, Optional, Sequence, Tuple, Union

__all__ = [
    "AUTO",
    "ForwardTableKind",
    "VOQKind",
    "SchedulerKind",
    "CustomKernelSpec",
    "SwitchArch",
    "ArchRequest",
    "enumerate_candidates",
    "BUS_WIDTHS",
    "VOQ_DEPTHS",
]


class _Auto:
    _inst: Optional["_Auto"] = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "AUTO"


AUTO = _Auto()


class ForwardTableKind(enum.Enum):
    FULL_LOOKUP = "full_lookup"      # direct-indexed, 1-cycle, O(2^addr_bits) memory
    MULTIBANK_HASH = "multibank_hash"  # banked hash table, handles long addresses


class VOQKind(enum.Enum):
    NXN = "nxn"        # fully partitioned N*N data queues (duplication on broadcast)
    SHARED = "shared"  # central buffer + pointer queues + pending bitmap


class SchedulerKind(enum.Enum):
    RR = "rr"          # rotating-priority, cheapest logic
    ISLIP = "islip"    # iterative request/grant/accept, ~100% uniform throughput
    EDRRM = "edrrm"    # 2-phase exhaustive dual round-robin, burst-friendly


#: legal bus widths (bits) — the DSE sweeps these (Table II column "Width")
BUS_WIDTHS: Tuple[int, ...] = (128, 256, 512, 1024)
#: candidate per-queue depths (packets) for stage-3 statistical sizing
VOQ_DEPTHS: Tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024, 2048)


@dataclasses.dataclass(frozen=True)
class CustomKernelSpec:
    """User compute kernel injected post-parsing (§III-B.5).

    ``ii``/``latency_cycles``/resources form the performance interface the
    user must declare so the DSE can account for the kernel; ``fn`` is the
    functional model (meta, data) -> (meta, data) used by the simulators.

    The cycle-level switch calls ``fn(state, pids, out_port, valid, cyc) ->
    (state, out_port, valid)`` once a cycle, idle cycles too, after the
    forward table's lookup and before the VOQ enqueue, each spec in order,
    on CPU tensors whether the switch runs on the CPU or on a card: int64
    ``pids`` [N] (-1 no packet) and ``out_port`` [N] (a port, -2 broadcast,
    -1 none; any other value queues nothing), bool ``valid`` [N], a 0-d
    int64 ``cyc``.  ``state`` starts as the attribute ``init_state`` (None
    without one) and whatever ``fn`` returns is passed to the next cycle
    unchanged.  ``fn`` must not write into its arguments.  An exception in
    ``fn`` ends the simulation.
    """

    name: str
    ii: int = 1
    latency_cycles: int = 4
    luts: int = 2000
    ffs: int = 2000
    brams: int = 0
    fn: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class SwitchArch:
    """A fully concrete switch micro-architecture (one Algorithm-1 template)."""

    n_ports: int
    bus_bits: int
    fwd: ForwardTableKind
    voq: VOQKind
    sched: SchedulerKind
    voq_depth: int = 64            # packets per virtual queue (stage 3 resizes)
    hash_banks: int = 4
    hash_depth: int = 256          # entries per bank
    islip_iters: int = 2
    addr_bits: int = 8             # from the bound protocol's routing_key
    custom_kernels: Tuple[CustomKernelSpec, ...] = ()

    # ---------------------------------------------------------------- timing
    @property
    def ii(self) -> int:
        """Initiation interval (cycles/flit) of the datapath (paper §IV-A.2).

        The streaming datapath is II=1 by construction except MultiBankHash,
        whose bank-conflict resolution serialises colliding lookups — we model
        the *guaranteed* II here (worst case folded into the simulators).
        """
        return 1

    @property
    def pipeline_depth(self) -> int:
        """Deterministic pipeline latency in cycles (parser→…→deparser)."""
        parser = 3
        fwd = 1 if self.fwd is ForwardTableKind.FULL_LOOKUP else 3
        voq = 3 if self.voq is VOQKind.NXN else 4       # pointer mgmt overhead
        sched = {SchedulerKind.RR: 1, SchedulerKind.EDRRM: 2, SchedulerKind.ISLIP: 2}[self.sched]
        if self.sched is SchedulerKind.ISLIP:
            sched += self.islip_iters - 1
        deparser = 2
        kern = sum(k.latency_cycles for k in self.custom_kernels)
        return parser + fwd + voq + sched + deparser + kern

    def with_depth(self, depth: int) -> "SwitchArch":
        return dataclasses.replace(self, voq_depth=depth)

    def short(self) -> str:
        k = {"full_lookup": "Full", "multibank_hash": "MBH"}[self.fwd.value]
        v = {"nxn": "NxN", "shared": "Shared"}[self.voq.value]
        return f"{k}/{v}/{self.sched.value.upper()}@{self.bus_bits}b d{self.voq_depth}"


Policy = Union[_Auto, ForwardTableKind, VOQKind, SchedulerKind, int]


@dataclasses.dataclass(frozen=True)
class ArchRequest:
    """What the user writes in the DSL: any policy may be AUTO (§III-A)."""

    n_ports: int
    addr_bits: int
    bus_bits: Union[int, _Auto] = AUTO
    fwd: Union[ForwardTableKind, _Auto] = AUTO
    voq: Union[VOQKind, _Auto] = AUTO
    sched: Union[SchedulerKind, _Auto] = AUTO
    voq_depth: Union[int, _Auto] = AUTO
    custom_kernels: Tuple[CustomKernelSpec, ...] = ()


def _choices(value, options) -> Sequence:
    return list(options) if value is AUTO else [value]


def enumerate_candidates(req: ArchRequest) -> List[SwitchArch]:
    """Expand every AUTO policy into the concrete template set for the DSE."""
    out: List[SwitchArch] = []
    fwd_opts = _choices(req.fwd, list(ForwardTableKind))
    # FullLookup memory is 2^addr_bits * port entries: prune absurd address widths
    fwd_opts = [
        f for f in fwd_opts
        if not (f is ForwardTableKind.FULL_LOOKUP and req.addr_bits > 16)
    ] or [ForwardTableKind.MULTIBANK_HASH]
    for bus, fwd, voq, sched in itertools.product(
        _choices(req.bus_bits, BUS_WIDTHS),
        fwd_opts,
        _choices(req.voq, list(VOQKind)),
        _choices(req.sched, list(SchedulerKind)),
    ):
        depth = 64 if req.voq_depth is AUTO else req.voq_depth
        out.append(
            SwitchArch(
                n_ports=req.n_ports,
                bus_bits=bus,
                fwd=fwd,
                voq=voq,
                sched=sched,
                voq_depth=depth,
                addr_bits=req.addr_bits,
                custom_kernels=req.custom_kernels,
            )
        )
    return out
