"""Time the attention and SSD kernels and the serving path (d) of
``chip_smoke.py`` from one tree of the repo, so that two trees can be
compared on one card.

    python3 tests/torch_serving_ab.py                  # this tree's package
    python3 tests/torch_serving_ab.py --src OTHER/src  # another tree's

Run it from each tree in turns (A, B, B, A) in one session on the card.  It
measures, with the port's seeded init and the settings of path (d):

  - ``flash_attention`` and PyTorch's SDPA (ms per call, CUDA events) at
    chip_smoke.py's bfloat16 forms: llama3.2-1b's prefill, D 128, window;
  - ``ssd_scan`` (ms per call, CUDA events) at chip_smoke.py's SSD shapes
    with x in float32 and bfloat16 (B and C float32), and at mamba2-780m's
    prefill with B and C in bfloat16 as its model gives them (where the
    tree's wrapper takes them);
  - llama3.2-1b's and mamba2-780m's full-width prefill of 4 x 8,192 tokens,
    twice each (wall);
  - ``ServeEngine`` on llama3.2-1b at the launcher's defaults, ``--serves``
    times in a row (wall, ticks, ms per tick, tokens/s).

Needs a CUDA card; prints the card's name and power limit, then one JSON
line per result.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (name, B, Hq, Hkv, S, D, window): chip_smoke.py's bfloat16 wgmma forms
FORMS = (("llama_prefill", 4, 32, 8, 8192, 64, 0), ("gqa_d128", 2, 16, 4, 1024, 128, 0),
         ("hymba_window", 1, 25, 5, 4096, 64, 1024))
#: (name, heads per sequence, BH, S, P, N): chip_smoke.py's SSD_FORMS
SSD_FORMS = (("mamba_prefill", 48, 192, 8192, 64, 128),
             ("mamba_ragged", 48, 192, 1000, 64, 128),
             ("hymba_prefill", 50, 100, 2048, 64, 16))
#: chip_smoke.py's PREFILL_BS and SERVE_ENGINE
PREFILL_BS = (4, 8192)
SERVE_ENGINE = dict(requests=8, slots=4, max_new=16, s_max=256)


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def cuda_ms(torch, fn, reps=10):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def time_attention(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    for name, b, hq, hkv, s, d, window in FORMS:
        g = torch.Generator(dev).manual_seed(s + hq)
        q, k, v = (torch.randn(shape, generator=g, device=dev).bfloat16()
                   for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        rec = {"form": name, "ms": cuda_ms(torch, lambda: fk.flash_attention(
            q, k, v, causal=True, window=window))}
        if not window:
            rec["sdpa_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        print(json.dumps(rec), flush=True)


def time_ssd(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels.ssd import kernel as sk
    for name, heads, bh, s, p, n in SSD_FORMS:
        g = torch.Generator(dev).manual_seed(s)          # chip_smoke.py's _ssd_inputs
        x = torch.randn((bh, s, p), generator=g, device=dev)
        dt = F.softplus(torch.randn((bh, s), generator=g, device=dev))
        a = -torch.ones((bh,), device=dev)
        b = torch.randn((bh // heads, s, n), generator=g, device=dev) * n ** -0.5
        c = torch.randn((bh // heads, s, n), generator=g, device=dev) * n ** -0.5
        forms = [("f32", x, b, c), ("bf16", x.bfloat16(), b, c)]
        if name == "mamba_prefill" and hasattr(sk, "plan"):   # takes bf16 B and C
            forms.append(("bf16_bc_bf16", x.bfloat16(), b.bfloat16(), c.bfloat16()))
        for form, xi, bi, ci in forms:
            rec = {"ssd": name, "form": "x_" + form, "ms": cuda_ms(
                torch, lambda: sk.ssd_scan(xi, dt, a, bi, ci))}
            print(json.dumps(rec), flush=True)


def time_prefill(torch, dev, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import SINGLE_POD_PLAN as PLAN
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    params = T.init_params(torch.Generator(dev).manual_seed(0), cfg, PLAN)
    b, s = PREFILL_BS
    tok = torch.randint(0, cfg.vocab, (b, s), device=dev,
                        generator=torch.Generator(dev).manual_seed(1))
    for run in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = T.prefill(params, cfg, PLAN, None, {"tokens": tok})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({"prefill": cfg.name, "run": run, "wall_s": wall,
                          "tokens_per_s": b * s / wall,
                          "finite": bool(torch.isfinite(logits.float()).all())}),
              flush=True)
        del logits
    return cfg, params


def time_serving(torch, dev, serves):
    from repro_torch.launch import serve as launcher
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    time_prefill(torch, dev, "mamba2-780m")
    torch.cuda.empty_cache()
    cfg, params = time_prefill(torch, dev, "llama3.2-1b")
    torch.cuda.empty_cache()
    for run in range(1, serves + 1):
        res = launcher.serve(cfg, params, **SERVE_ENGINE)
        res.pop("done")
        print(json.dumps({"serve": cfg.name, "run": run, **res,
                          "ms_per_tick": res["wall_s"] * 1e3 / max(res["ticks"], 1),
                          "tokens_per_s": res["tokens"] / res["wall_s"]}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(REPO, "src"),
                    help="the directory holding the repro_torch package to time")
    ap.add_argument("--serves", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_serving_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(card(), flush=True)
    print(json.dumps({"src": os.path.abspath(args.src)}), flush=True)
    time_attention(torch, dev)
    time_ssd(torch, dev)
    time_serving(torch, dev, args.serves)
    return 0


if __name__ == "__main__":
    sys.exit(main())
