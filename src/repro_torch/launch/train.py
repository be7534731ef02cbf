"""Production training driver.

    python -m repro_torch.launch.train --arch llama3.2-1b --smoke \\
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/run1 [--device cuda|cpu]

The port's counterpart of the JAX package's ``launch/train.py``: the
reference's flags plus ``--device`` (default: the first CUDA device; raises
without one).  ``--smoke`` trains the reduced config on a 1x1 mesh;
otherwise the full config runs under the production mesh (``--mesh
single|multi``: 256 or 512 devices), which a host without that many
devices refuses with the mesh's own device-count message, as the reference
is refused.  Weights come from a ``torch.Generator`` seeded with 0 (the
reference's ``PRNGKey(0)`` gives other numbers); the data from
``SyntheticLM`` (the reference's batches, bitwise).  The loop runs under the
fault-tolerant ``Supervisor`` with async checkpoints.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.moe import MoEOptions
from repro_torch.runtime import Supervisor
from repro_torch.train import TrainSpec, adafactor, adamw, make_train_step
from .mesh import make_production_mesh, make_smoke_mesh, plan_for_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config on a 1x1 mesh")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", choices=["adamw", "adafactor"], default="adamw")
    ap.add_argument("--moe-payload", choices=["bf16", "int8"], default="bf16")
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    try:
        if args.smoke:
            cfg = get_smoke(args.arch)
            mesh = make_smoke_mesh(device=dev)
        else:
            cfg = get_config(args.arch)
            mesh = make_production_mesh(multi_pod=args.mesh == "multi", device=dev)
    except ValueError as e:                 # the mesh's device-count message
        print(f"train: {e}", file=sys.stderr)
        return 2
    plan = plan_for_mesh(mesh)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.0f}M mesh={mesh.shape} "
          f"device={dev}")

    params = T.init_params(torch.Generator(dev).manual_seed(0), cfg, plan)
    opt = adamw(lr=args.lr) if args.optimizer == "adamw" else adafactor(lr=args.lr)
    spec = TrainSpec(microbatches=args.microbatches, lr=args.lr,
                     warmup_steps=max(args.steps // 20, 2), total_steps=args.steps,
                     moe_opts=MoEOptions(payload=args.moe_payload,
                                         capacity_factor=cfg.capacity_factor),
                     compress_pod_grads=args.compress_pod_grads)
    step = make_train_step(cfg, plan, mesh, opt, spec)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch,
                                  frontend=cfg.frontend, d_model=cfg.d_model,
                                  mrope=cfg.mrope))

    def step_fn(state, i):
        p, o = state
        p, o, m = step(p, o, data.batch(i), i)
        return (p, o), m

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_")
    sup = Supervisor(ckpt_dir, ckpt_every=args.ckpt_every)
    t0 = time.time()
    res = sup.run((params, opt.init(params)), step_fn, total_steps=args.steps)
    losses = [h["loss"] for h in res.metrics_history]
    print(f"{res.final_step} steps in {time.time()-t0:.0f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; ckpts in {ckpt_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
