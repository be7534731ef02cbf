"""Quickstart on the PyTorch/CUDA port: the two-stage SPAC workflow as one
declarative Scenario.  ``examples/quickstart.py`` on ``repro_torch``.

Stage 1 — define a custom protocol in the DSL and semantically bind it.
Stage 2 — wrap protocol + trace + SLA in a ``Scenario`` (every architecture
policy on AUTO) and run it; the DSE returns the Pareto-optimal switch,
verified in the hardware-aware simulator.  The same spec serializes to JSON,
so the experiment is reproducible from a config file (or the CLI:
``python -m repro_torch run hft --sla-p99-ns 5000``).

    pip install -e .   # once (or PYTHONPATH=src)
    python examples/quickstart_torch.py                # on the card
    python examples/quickstart_torch.py --device cpu
"""

import argparse

from repro_torch.api import ProtocolSpec, Scenario, TraceSpec, run_scenario
from repro_torch.api.scenario import Fidelity
from repro_torch.core import ArchRequest, SLA, analyze, ethernet_ipv4_udp
from repro_torch.api.runner import build_bound
from repro_torch.sim import synthesize


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # ---- the whole experiment, declaratively (a JSON-serializable spec)
    scenario = Scenario(
        name="hft_quickstart",
        protocol=ProtocolSpec(
            builder="compressed_protocol",
            params={"name": "hft_wire", "addr_bits": 4, "qos_bits": 2,
                    "length_bits": 6}),                   # 2-byte header
        flit_bits=256,
        trace=TraceSpec(generator="hft", params={"seed": 0}),
        arch=ArchRequest(n_ports=8, addr_bits=4),         # every policy AUTO
        sla=SLA(p99_latency_ns=5_000, drop_rate=1e-3),
        fidelity=Fidelity(back_annotation=True),
    )
    print("scenario spec (reproducible config):")
    print(scenario.to_json())

    # ---- protocol definition + semantic binding (single source of truth)
    bound = build_bound(scenario)
    print()
    print(bound.describe())
    print(f"vs Ethernet/IP/UDP: {ethernet_ipv4_udp().header_bytes} B of header\n")

    # ---- trace-aware DSE (Algorithm 1, batched stage-2 fan-out)
    print("trace:", analyze(scenario.trace.build()).describe())
    report = run_scenario(scenario, verbose=True, device=args.device)
    print()
    print(report.summary())

    best = report.best
    rep = synthesize(best, bound)
    print(f"\nselected micro-architecture : {best.short()}")
    print(f"resources                   : {rep.luts/1e3:.1f}k LUT, "
          f"{rep.brams:.0f} BRAM @ {rep.fmax_mhz:.0f} MHz")
    print(f"verified                    : p99 {report.best_verify.p99_latency_ns:.0f} ns, "
          f"drops {report.best_verify.drop_rate:.2e}")


if __name__ == "__main__":
    main()
