"""The port's bfloat16 distance from the JAX package, over seeds: the
measurements behind the bfloat16 bars of ``tests/test_torch_model.py``.

    # smoke-width forward logits of every architecture (CPU; both packages)
    PYTHONPATH=src python tests/torch_bf16_gaps.py forward --seeds 0,1,2,3
    # the reference's fixture logits (full width, 2 layers, 1 x 1,024
    # tokens, bfloat16) at more seeds (CPU; the JAX package)
    PYTHONPATH=src python tests/torch_bf16_gaps.py write build/bf16_gaps --seeds 1,2,3
    # the port's prefill against tests/torch_golden/ (seed 0) and those
    # (PyTorch only: runs on the card)
    PYTHONPATH=src python tests/torch_bf16_gaps.py prefill build/bf16_gaps --device cuda

Each result is one JSON line: ``rel`` = max |diff| / max |logit|, and
``worst_at_2e-2`` = max |diff| / (2e-2 + 2e-2·|want|), which elementwise
atol = rtol = 2e-2 passes at or below 1.  ``forward`` and ``write`` run the
reference compiled as written (``test_torch_model.ref_as_written``).
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
FIXTURES = {"model_llama": "llama3.2-1b", "model_mamba": "mamba2-780m"}


def gaps(got, want):
    d = np.abs(got - want)
    return {"max_abs": float(d.max()), "rel": float(d.max() / np.abs(want).max()),
            "worst_at_2e-2": float((d / (2e-2 + 2e-2 * np.abs(want))).max())}


def bf16_bits_to_f32(a):
    return (np.asarray(a).astype(np.uint32) << 16).view(np.float32)


def forward(seeds):
    import test_torch_model as M
    from repro.launch.mesh import compat_make_mesh
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    for name in M.all_arch_names():
        for seed in seeds:
            rc, pc, rp, pp = M._both(name, "bfloat16", mesh, seed=seed)
            rb, pb = M._batch(pc, np.random.default_rng(1 + seed))
            r, _ = M.ref_as_written(
                lambda p, b: M.RT.forward(p, rc, M.REF_PLAN, mesh, b), rp, rb)
            p, _ = M.PT.forward(pp, pc, M.SINGLE_POD_PLAN, None, pb)
            print(json.dumps({"arch": name, "seed": seed, **gaps(M._np(p), M._np(r))}),
                  flush=True)


def write(out, seeds):
    import jax.numpy as jnp
    import test_torch_model as M
    from repro.launch.mesh import compat_make_mesh
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    out.mkdir(parents=True, exist_ok=True)
    for stem, arch in FIXTURES.items():
        rc, pc = M.fixture_config(arch, "bfloat16")
        for seed in seeds:
            arrays = M.convert.seeded_model_arrays(pc, seed)
            tok = M.fixture_tokens(pc, seed=seed)
            lg, _ = M.ref_as_written(lambda p, b: M.RT.prefill(p, rc, M.REF_PLAN, mesh, b),
                                     M.ref_params(arrays), {"tokens": jnp.asarray(tok)})
            np.savez_compressed(out / f"{stem}_s{seed}.npz", tokens=tok,
                                logits_bf16=np.asarray(lg).view(np.uint16))
            print(f"{stem} seed {seed} written", flush=True)


def prefill(out, device):
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import SINGLE_POD_PLAN
    from repro_torch.models import transformer as T
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    for stem, arch in FIXTURES.items():
        meta = json.loads((REPO / "tests" / "torch_golden" / f"{stem}.json").read_text())
        files = [(meta["seed"], REPO / "tests" / "torch_golden" / f"{stem}.npz")]
        files += sorted((int(f.stem.rsplit("_s", 1)[1]), f)
                        for f in out.glob(f"{stem}_s*.npz"))
        cfg = dataclasses.replace(get_config(arch), n_layers=meta["n_layers"],
                                  attn_impl=meta["attn_impl"], dtype="bfloat16")
        for seed, f in files:
            with np.load(f) as z:
                tok, want = z["tokens"], bf16_bits_to_f32(z["logits_bf16"])
            params = convert.model_params(convert.seeded_model_arrays(cfg, seed), dev)
            lg, _ = T.prefill(params, cfg, SINGLE_POD_PLAN, None,
                              {"tokens": torch.from_numpy(tok).long().to(dev)})
            got = lg.float().cpu().numpy()
            print(json.dumps({"fixture": stem, "seed": seed, "device": str(dev),
                              **gaps(got, want)}), flush=True)
            del params, lg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["forward", "write", "prefill"])
    ap.add_argument("dir", nargs="?", type=Path, default=REPO / "build" / "bf16_gaps")
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--device", default=None, help="prefill: cuda (default) or cpu")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.mode == "forward":
        forward(seeds)
    elif args.mode == "write":
        write(args.dir, seeds)
    else:
        prefill(args.dir, args.device)


if __name__ == "__main__":
    sys.exit(main())
