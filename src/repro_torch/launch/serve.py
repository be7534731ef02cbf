"""Serving driver: continuous batching over the decode step.

    python -m repro_torch.launch.serve --arch llama3.2-1b [--smoke] \\
        --requests 8 --slots 4 --max-new 16 --s-max 256 [--device cuda|cpu]

The reference's flags plus ``--device`` (default: the first CUDA device;
raises without one).  ``--mesh single`` (the default) serves on one device,
with ``SINGLE_POD_PLAN`` and no mesh; ``--mesh multi`` builds the
reference's multi-pod production mesh (512 devices), which a host without
that many devices refuses with the mesh's device-count message (exit 2).
Weights come from a ``torch.Generator`` seeded with 0 (the reference's
``PRNGKey(0)`` gives other numbers); prompts from NumPy's
``default_rng(0)``, as in the reference.  The loop drives
``ServeEngine.run_until_drained``; ``serve`` is that loop on given weights.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_mesh, plan_for_mesh
from repro_torch.models import SINGLE_POD_PLAN
from repro_torch.models import transformer as T
from repro_torch.serve import Request, ServeEngine


def serve(cfg, params, *, requests: int = 8, slots: int = 4, max_new: int = 16,
          s_max: int = 256, plan=SINGLE_POD_PLAN, mesh=None) -> Dict[str, Any]:
    """Serve ``requests`` prompts of 4-11 tokens from NumPy's
    ``default_rng(0)`` through a ``ServeEngine`` on ``params``' device until
    it drains.  Returns the finished requests (``done``), their count
    (``served``), the tokens generated, the engine ticks and the wall time
    (host clock, ending in a synchronize on CUDA)."""
    dev = next(iter(params.values())).device
    eng = ServeEngine(cfg, plan, mesh, params, slots=slots, s_max=s_max)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, rng.integers(4, 12))
                    .astype(np.int32), max_new=max_new)
            for i in range(requests)]
    for r in reqs:
        eng.submit(r)
    ticks, done = 0, []
    t0 = time.perf_counter()
    while not eng.drained:
        done += eng.run_until_drained(max_ticks=1)
        ticks += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"done": done, "requests": requests, "served": len(done),
            "tokens": sum(len(r.out) for r in done), "ticks": ticks,
            "wall_time_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--s-max", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    plan, mesh = SINGLE_POD_PLAN, None
    if args.mesh == "multi":
        try:
            mesh = make_production_mesh(multi_pod=True, device=dev)
        except ValueError as e:             # the mesh's device-count message
            print(f"serve: {e}", file=sys.stderr)
            return 2
        plan = plan_for_mesh(mesh)
    params = T.init_params(torch.Generator(dev).manual_seed(0), cfg, plan)
    res = serve(cfg, params, requests=args.requests, slots=args.slots,
                max_new=args.max_new, s_max=args.s_max, plan=plan, mesh=mesh)
    dt, ticks = res["wall_time_s"], res["ticks"]
    print(f"served {res['served']}/{res['requests']} requests, {res['tokens']} tokens, "
          f"{ticks} ticks, {dt:.1f}s ({1e3 * dt / max(ticks, 1):.2f} ms per tick) on {dev}")
    return 0 if res["served"] == res["requests"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
