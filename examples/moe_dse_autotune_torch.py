"""Beyond-paper demo on the PyTorch/CUDA port: SPAC's Algorithm 1 auto-tuning
the MoE dispatch fabric.  ``examples/moe_dse_autotune.py`` on ``repro_torch``.

The layer's token→expert traffic is extracted as a routing trace (packets →
output ports), the DSE sizes the capacity factor from the expert-load
histogram at a target token-drop rate (the paper's VOQ-depth sizing), picks
the payload protocol (bf16 vs int8 wire format) and the all-to-all schedule,
then verifies on the real fabric.

The whole experiment is the registry's ``moe_dispatch`` scenario — one
serializable spec (``python -m repro_torch show moe_dispatch``);
``autotune_moe`` remains the legacy one-call wrapper over the same
machinery.  The layer's weights come from the port's seeded init, not the
reference's ``jax.random``, so the numbers differ from the JAX package's.

    pip install -e .   # once (or PYTHONPATH=src)
    python examples/moe_dse_autotune_torch.py                # on the card
    python examples/moe_dse_autotune_torch.py --device cpu
"""

import argparse

from repro_torch.api import registry, run_scenario
from repro_torch.models import MoEOptions
from repro_torch.models.moe import apply_moe


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    scenario = registry["moe_dispatch"]
    print("scenario spec:", scenario.to_json(), sep="\n")

    report = run_scenario(scenario, verbose=True, device=args.device)
    problem = report.problem                    # the live CommDSEProblem

    # fixed general-purpose baseline (the "SPAC Ethernet" of the fabric)
    _, aux = apply_moe(problem.params, problem.cfg, problem.plan, problem.mesh,
                       problem.sample_x, MoEOptions(capacity_factor=1.25))
    load = aux["expert_load"].double().cpu().numpy()
    print(f"\nbaseline  : cf=1.25/bf16/a2a×1  drop={float(aux['drop_frac']):.4f} "
          f"load_cv={load.std()/load.mean():.2f}")

    result = report.result
    print()
    print(result.summary())
    best = result.best
    print(f"\nselected CommSpec : {best.short()}")
    print(f"verified drop     : {result.best_verify.drop_rate:.4f} "
          f"(target ε={scenario.sla.drop_rate:g}, statistical sizing from "
          "the routing trace)")
    print(f"dispatch buffers  : {problem._buffer_bytes(best)/1e6:.2f} MB/device "
          f"(wire {problem._a2a_bytes(best)/1e6:.2f} MB/step)")
    print("\nPareto front:")
    for c, v in result.pareto:
        print(f"  {c.short():32s} step≈{v.p99_latency_ns/1e3:.1f}µs drop={v.drop_rate:.4f}")


if __name__ == "__main__":
    main()
