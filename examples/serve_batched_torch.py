"""Serving driver on the PyTorch/CUDA port: continuous batching over the
decode step.  ``examples/serve_batched.py`` on ``repro_torch``; the weights
come from a ``torch.Generator`` seeded with 0 (the reference's
``PRNGKey(0)`` gives other numbers).

    pip install -e .   # once (or PYTHONPATH=src)
    python examples/serve_batched_torch.py --arch llama3.2-1b                # on the card
    python examples/serve_batched_torch.py --arch llama3.2-1b --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models import SINGLE_POD_PLAN
from repro_torch.models import transformer as T
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = compat_make_mesh((1, 1), ("data", "model"), device=dev)
    cfg = get_smoke(args.arch)
    plan = SINGLE_POD_PLAN
    params = T.init_params(torch.Generator(dev).manual_seed(0), cfg, plan)
    eng = ServeEngine(cfg, plan, mesh, params, slots=args.slots, s_max=128)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, rng.integers(3, 9))
                    .astype(np.int32), max_new=args.max_new,
                    temperature=0.0 if i % 2 else 0.8)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)

    t0 = time.time()
    finished = eng.run_until_drained(max_ticks=10_000)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in reqs)
    print(f"{len(finished)}/{len(reqs)} requests served, {toks} tokens "
          f"({dt:.1f}s, {toks/dt:.1f} tok/s on {dev}, slots={args.slots})")
    for r in reqs[:4]:
        print(f"  req{r.rid}: prompt{list(r.prompt[:4])}… -> {r.out}")
    assert len(finished) == len(reqs) and all(r.done for r in finished)


if __name__ == "__main__":
    main()
