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
    # the bfloat16 attention kernel's bar over seeds, at chip_smoke.py's
    # llama_prefill and gqa_d128 forms, against the plain version as it is
    # (P = exp(s - m)) and formed as the kernel forms it (P = 2^(x c - m c),
    # c = scale * log2 e); PyTorch only, on the card
    python3 tests/torch_bf16_gaps.py flash-seeds --seeds 0-31

Each result is one JSON line: ``rel`` = max |diff| / max |logit|, and
``worst_at_2e-2`` = max |diff| / (2e-2 + 2e-2·|want|), which elementwise
atol = rtol = 2e-2 passes at or below 1.  ``flash-seeds`` prints per seed
and form the largest share of the bar (atol 1e-3 + rtol 2**-7·|want|) and
the first row past it, for each plain version.  ``forward`` and ``write`` run the
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


def blockwise_exp2(q, k, v, *, causal=True, window=0, block_k=128):
    """The plain version with P formed as the wgmma kernel forms it
    (``csrc/flash_attention.cu`` ``softmax``): raw scores x = q.k, the
    running max m of raw scores, p = 2^fma(x, c, -(m c)) with
    c = float32(scale) * float32(log2 e), alpha = 2^((m_old - m) c).  The
    fma is taken exactly in float64 and rounded once."""
    import torch
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    rep = h // hkv
    c = torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    neg = -1e30
    dev = q.device
    qi = q.reshape(b, hkv, rep, s, hd).float()
    kf, vf = k.float(), v.float()
    rows = torch.arange(s, device=dev)[:, None] + (t - s)
    m = torch.full((b, hkv, rep, s, 1), neg, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, rep, s, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, rep, s, hd), dtype=torch.float32, device=dev)
    cd = c.double().item()
    for k0 in range(0, t, block_k):
        ks, vs = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        x = torch.einsum("bkrqd,bkKd->bkrqK", qi, ks)
        cols = k0 + torch.arange(ks.shape[2], device=dev)[None, :]
        if causal:
            x = x.masked_fill(rows < cols, neg)
        if window:
            x = x.masked_fill(rows - cols >= window, neg)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        mc = m_new * c.item()
        p = torch.exp2((x.double() * cd - mc.double()).float())
        p = torch.where(m_new == neg, torch.ones_like(p), p)
        alpha = torch.exp2((m - m_new) * c.item())
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkrqK,bkKd->bkrqd", p.to(q.dtype).float(), vs)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype).reshape(b, h, s, hd)


def flash_seeds(seeds):
    import importlib.util
    import torch
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import blockwise_ref
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    for form in cs.FLASH_SEED_FORMS:
        _, shape, b, hq, hkv, s, d, window, _ = next(f for f in cs.FLASH_FORMS
                                                     if f[1] == form)
        for seed in seeds:
            q, k, v = cs._attn_inputs(b, hq, hkv, s, d, dev, torch.bfloat16, seed)
            got = fk.flash_attention(q, k, v, causal=True, window=window).float()
            rec = {"form": shape, "seed": seed}
            for name, want in (("exp", blockwise_ref(q, k, v, causal=True, window=window,
                                                     block_k=fk.KEY_TILE)),
                               ("exp2", blockwise_exp2(q, k, v, causal=True,
                                                       window=window,
                                                       block_k=fk.KEY_TILE))):
                rec[name] = cs.flash_bar_share(got, want.float())
            print(json.dumps(rec), flush=True)
            del q, k, v, got


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["forward", "write", "prefill", "flash-seeds"])
    ap.add_argument("dir", nargs="?", type=Path, default=REPO / "build" / "bf16_gaps")
    ap.add_argument("--seeds", default="0,1,2,3", help="a list (0,1,2) or a range (0-31)")
    ap.add_argument("--device", default=None, help="prefill: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if "-" in args.seeds:
        lo, hi = (int(x) for x in args.seeds.split("-"))
        seeds = list(range(lo, hi + 1))
    else:
        seeds = [int(s) for s in args.seeds.split(",")]
    if args.mode == "flash-seeds":
        flash_seeds(seeds)
    elif args.mode == "forward":
        forward(seeds)
    elif args.mode == "write":
        write(args.dir, seeds)
    else:
        prefill(args.dir, args.device)


if __name__ == "__main__":
    sys.exit(main())
