"""In-network computing (§III-B.5) on the PyTorch/CUDA port: inject a custom
aggregation kernel into the switch pipeline — the iSwitch-style in-switch
all-reduce the paper cites as future work, built on SPAC's custom-kernel
hooks.  ``examples/inswitch_allreduce.py`` on ``repro_torch``, with the hook
written in PyTorch.

The kernel consumes gradient packets addressed to the aggregator port and
releases one aggregated packet per round once all workers have contributed,
cutting aggregator-port egress by ~(N-1)/N.

On a card the switch runs the hooked architecture as two launches of its
cycle-loop kernel (every cycle's ingress, then every cycle's egress) with the
hook stepped once a cycle on the host between them; on the CPU the eager
loop calls it inside each cycle.  The printed lines are the JAX package's.

    pip install -e .   # once (or PYTHONPATH=src)
    python examples/inswitch_allreduce_torch.py                # on the card
    python examples/inswitch_allreduce_torch.py --device cpu   # ~6 min a switch
"""

import argparse
import sys
import time

import torch

from repro_torch.core import (CustomKernelSpec, SchedulerKind, SwitchArch,
                              ForwardTableKind, VOQKind, bind, compressed_protocol)
from repro_torch.sim import synthesize
from repro_torch.switch import simulate
from repro_torch.traces import rl_allreduce


def make_aggregation_kernel(n_workers: int, agg_port: int = 0) -> CustomKernelSpec:
    """Stateful hook: count contributions per round; drop all but the last
    packet of each round (the survivor models the aggregated result)."""

    def fn(kstate, pids, out_port, valid, cyc):
        count = kstate                                  # contributions mod n
        to_agg = valid & (out_port == agg_port)
        # position of each simultaneous contribution within the round
        seen = torch.cumsum(to_agg, 0)
        keep_agg = to_agg & ((count + seen) % n_workers == 0)   # release one per round
        count = (count + seen[-1]) % n_workers
        keep = ~to_agg | keep_agg
        return count, out_port, valid & keep

    spec = CustomKernelSpec(name="allreduce_agg", ii=1, latency_cycles=6,
                            luts=9000, ffs=7000, brams=8, fn=fn)
    object.__setattr__(spec, "init_state", torch.zeros((), dtype=torch.int64))
    return spec


def architectures(n: int):
    """The baseline switch and the same switch with the aggregation kernel."""
    base = SwitchArch(n_ports=n, bus_bits=1024, fwd=ForwardTableKind.FULL_LOOKUP,
                      voq=VOQKind.NXN, sched=SchedulerKind.EDRRM, voq_depth=512,
                      addr_bits=4)
    inc = SwitchArch(n_ports=n, bus_bits=1024, fwd=ForwardTableKind.FULL_LOOKUP,
                     voq=VOQKind.NXN, sched=SchedulerKind.EDRRM, voq_depth=512,
                     addr_bits=4, custom_kernels=(make_aggregation_kernel(n - 1),))
    return (("baseline", base), ("in-switch-aggregation", inc))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    n = 8
    tr = rl_allreduce(seed=0, n_ports=n)
    bound = bind(compressed_protocol(addr_bits=4, length_bits=12), flit_bits=1024)

    for name, arch in architectures(n):
        rep = synthesize(arch, bound)
        t0 = time.perf_counter()
        res = simulate(arch, bound, tr, fclk_hz=rep.fmax_mhz * 1e6, device=args.device)
        print(f"{name}: {res.n_cycles} cycles simulated in "
              f"{time.perf_counter() - t0:.2f} s", file=sys.stderr)
        print(f"{name:24s} delivered={res.delivered_copies:5d} "
              f"p50={res.p(50):7.1f}ns p99={res.p(99):8.1f}ns "
              f"maxQ={int(res.occ_max.max()):4d} "
              f"LUT={rep.luts/1e3:6.1f}k (+kernel)")
    print("\nthe aggregation kernel absorbs the incast: the aggregator's VOQ "
          "backlog and egress volume drop by ~7/8 while worker traffic is "
          "unchanged — the deployment path for [46]-style gradient aggregation.")


if __name__ == "__main__":
    main()
