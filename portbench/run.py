"""Run one benchmark cell once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (an entry of ``BENCHMARK.json``'s
``workloads``) names its traffic file ``portbench/workloads/<cell>.json``,
whose ``driver`` (``portbench/drivers/<driver>.py``) runs it on the card:
set-up, the checked first steps, the measured window, and the comparison
with the plain reference.  With ``--trace 0`` the result's metrics are the
cell's end-to-end metrics; with ``--trace 1`` the window runs under
``torch.profiler`` and the metrics are its per-layer metrics, each read
by ``portbench/metrics/<metric>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), then ``checks``: each number compared, with its value and limit,
which the last lines of standard error repeat.  Exits 2 without enough
CUDA devices and 3 if JAX or the JAX package got loaded; prints no result
then.  Build caches stay inside the checkout (the kernels under
``build/``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the caching allocator grows its segments instead of keeping one per size:
#: the 16,384 x 131,072 logits' float32 buffers otherwise split the card
ALLOC = "expandable_segments:True"
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: top-level module names that the measured process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """The forbidden top-level names present in ``sys.modules``, compared
    whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, out, trace: bool, device: dict) -> dict:
    """The result object from a driver's output."""
    from portbench.metrics._kernels import Reading
    from portbench.spec import metric_reader

    checks = {k: {"value": out["numbers"][k], "limit": lim} for k, lim in out["limits"].items()}
    checks["failed_steps"] = {"value": out["failed"], "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if trace:
        rd = out["reading"]
        reading = Reading(kernels=rd["kernels"], steps=out["steps"], window_s=out["window_s"],
                          busy_s=rd["busy_s"], trace_window_s=rd["trace_window_s"],
                          model=out["model"], traffic=out["traffic"])
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device = dict(device, busy_s=rd["busy_s"], window_s=rd["trace_window_s"])
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if trace:
        tr = out["reading"]["trace"]
        line["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = ALLOC
    import torch

    from portbench.spec import cell as find_cell

    cell = find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run: {args.workload} needs {cell.chips} CUDA device(s); {have} available",
              file=sys.stderr)
        return 2
    out = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = result_line(cell, out, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"run: the measured process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v in out["numbers"].items():
        if name not in line["checks"]:
            print(f"reading {name} = {v!r} (not compared)", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
