"""End-to-end training driver on the PyTorch/CUDA port: a ~100M-parameter
llama-family model trained for a few hundred steps on synthetic data with
the full production substrate — microbatched train step, WSD schedule,
async checkpointing, fault-tolerant supervisor (with an injected crash to
prove restart), and exact data resume.  ``examples/train_e2e.py`` on
``repro_torch``; the weights come from a ``torch.Generator`` seeded with 0.

    pip install -e .   # once (or PYTHONPATH=src)
    python examples/train_e2e_torch.py --steps 200      # full run, on the card
    python examples/train_e2e_torch.py --steps 20       # quick look
    python examples/train_e2e_torch.py --steps 4 --seq 16 --device cpu
"""

import argparse
import tempfile
import time

import torch

from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models import SINGLE_POD_PLAN, ModelConfig
from repro_torch.models import transformer as T
from repro_torch.runtime import FaultInjector, Supervisor
from repro_torch.train import TrainSpec, adamw, make_train_step


def model_100m() -> ModelConfig:
    return ModelConfig(name="llama-100m", family="dense", n_layers=12,
                       d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
                       d_ff=2048, vocab=32000, rope_theta=1e4, remat="none")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--inject-crash", type=int, default=None,
                    help="step at which to kill the 'node' (default steps//2)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = compat_make_mesh((1, 1), ("data", "model"), device=dev)
    cfg = model_100m()
    plan = SINGLE_POD_PLAN
    print(f"model: {cfg.name} — {cfg.param_count()/1e6:.0f}M params")

    params = T.init_params(torch.Generator(dev).manual_seed(0), cfg, plan)
    opt = adamw(lr=6e-4)
    spec = TrainSpec(microbatches=2, lr=6e-4, warmup_steps=max(args.steps // 20, 2),
                     total_steps=args.steps, schedule="wsd")
    train_step = make_train_step(cfg, plan, mesh, opt, spec)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=0))

    def step_fn(state, step):
        p, o = state
        p, o, m = train_step(p, o, data.batch(step), step)
        return (p, o), m

    crash_at = args.inject_crash if args.inject_crash is not None else args.steps // 2
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="spac_e2e_")
    sup = Supervisor(ckpt_dir, ckpt_every=max(args.steps // 8, 5),
                     injector=FaultInjector(schedule={crash_at: "crash"}))

    t0 = time.time()
    res = sup.run((params, opt.init(params)), step_fn, total_steps=args.steps)
    dt = time.time() - t0
    losses = [h["loss"] for h in res.metrics_history]
    n_tok = args.batch * args.seq
    print(f"\n{res.final_step} steps in {dt:.0f}s "
          f"({n_tok * len(losses) / dt:.0f} tok/s incl. {res.restarts} restart(s))")
    k = max(len(losses) // 10, 1)
    print(f"loss: {sum(losses[:k])/k:.3f} -> {sum(losses[-k:])/k:.3f}")
    print(f"checkpoints in {ckpt_dir}")
    assert sum(losses[-k:]) / k < sum(losses[:k]) / k, "training must make progress"


if __name__ == "__main__":
    main()
