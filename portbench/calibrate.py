"""Readings that a cell's limits are set from, at the cell's own size, in
one process (the benchmark's runs do not run this):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control N] [--fault N] [--out FILE]

For every seed: the program's checked steps (sound) against the plain
reference's.  For the first ``--control`` seeds also the control (the
reference with fp8 operands) and for the first ``--fault`` seeds the
program with half of each batch's tokens left out of the loss, both
against the same reference.  Prints one JSON line per reading as it comes
and writes them all, with every leaf's readings, to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def _free():
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from portbench.run import ALLOC
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = ALLOC
    import torch

    from portbench.drivers import train as D
    from portbench.reference.common import Prec
    from portbench.spec import cell as find_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = find_cell(args.workload)
    prog = D.Program(cell, "cuda:0")
    rows = []

    def emit(**rec):
        rows.append(rec)
        print(json.dumps({k: v for k, v in rec.items() if k not in ("program", "reference")}),
              flush=True)
        for r in ("program", "reference"):
            if r in rec:
                rec[r] = {k: v for k, v in rec[r].items() if k != "grad_sample"}

    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        _, _, got, _ = D.first_steps(prog, seed)
        torch.cuda.synchronize()
        t_prog = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _free()
        t0 = time.perf_counter()
        ref = D.reference_readings(prog, seed)
        t_ref = time.perf_counter() - t0
        _free()
        emit(kind="sound", seed=seed, numbers=D.compare(got, ref), prog_s=t_prog,
             ref_s=t_ref, peak_gib=peak, program=got, reference=ref)
        if n < args.control:
            t0 = time.perf_counter()
            ctl = D.reference_readings(prog, seed, Prec.FP8)
            emit(kind="control_fp8", seed=seed, numbers=D.compare(ctl, ref),
                 seconds=time.perf_counter() - t0, program=ctl)
            _free()
        if n < args.fault:
            feed = D.half_batch(lambda i, s=seed: prog.batch(s, i))
            _, _, half, _ = D.first_steps(prog, seed, feed)
            emit(kind="fault_half_batch", seed=seed, numbers=D.compare(half, ref), program=half)
            _free()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
