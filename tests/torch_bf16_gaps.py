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
    # llama3.2-1b's fixture recipe op by op (CPU; both packages): each op of
    # the port fed the reference's own input, and both chains side by side
    PYTHONPATH=src python tests/torch_bf16_gaps.py layers --seeds 0
    # the bfloat16 attention kernel's bar over seeds, at chip_smoke.py's
    # llama_prefill and gqa_d128 forms, against the plain version as it is
    # (P = exp(s - m)) and formed as the kernel forms it (P = 2^(x c - m c),
    # c = scale * log2 e); PyTorch only, on the card
    python3 tests/torch_bf16_gaps.py flash-seeds --seeds 0-31

Each result is one JSON line: ``rel`` = max |diff| / max |logit|, and
``worst_at_2e-2`` = max |diff| / (2e-2 + 2e-2·|want|), which elementwise
atol = rtol = 2e-2 passes at or below 1.  ``flash-seeds`` prints per seed
and form the largest share of the bar (atol 1e-3 + rtol 2**-7·|want|) and
the first row past it, for each plain version.  ``layers`` prints one line
per op of llama3.2-1b's bfloat16 fixture recipe (embedding; per layer the
first norm, q/k/v, RoPE, attention, o-proj, residual, second norm, the
MLP's three products and its gate, residual; final norm; logits): ``op``
is the port's op fed the reference's input for it, against the
reference's output (``ulp_max``: the largest distance in bfloat16 ulps,
``frac_ulp1``/``frac_ulp2``: the shares of elements one and more than one
ulp apart), ``chain`` the port's own run against the reference's own run
up to that op (``rel`` and ``worst_at_2e-2`` on the logits).
``forward``, ``write`` and ``layers`` run the reference compiled as written
(``test_torch_model.ref_as_written``).
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


def _bf16_ulp(a):
    """The spacing of bfloat16 (8 significant bits) at |a| (float64)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _ulp_stats(got, want):
    """float64 arrays -> the distance in bfloat16 ulps at the larger of the
    two magnitudes: its maximum and the shares of elements one ulp (0 <
    d <= 1) and more than one ulp apart."""
    u = np.abs(got - want) / _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    return {"ulp_max": float(u.max()), "frac_ulp1": float(((u > 0) & (u <= 1)).mean()),
            "frac_ulp2": float((u > 1).mean())}


def _op_stats(got, want, exact=None):
    """got and want: bfloat16 bits (uint16); exact: float64 or None."""
    g = bf16_bits_to_f32(got).astype(np.float64)
    w = bf16_bits_to_f32(want).astype(np.float64)
    d = np.abs(g - w)
    out = {**_ulp_stats(g, w), "max_abs": float(d.max()),
           "rel": float(d.max() / max(np.abs(w).max(), 1e-30))}
    if exact is not None:
        # an output is faithfully rounded when it lies less than one ulp of
        # the exact value from it (one of the two bfloat16 values around it)
        for side, x in (("port", g), ("ref", w)):
            e = np.abs(x - exact) / _bf16_ulp(exact)
            out[f"{side}_vs_exact"] = {"ulp_max": float(e.max()),
                                      "frac_past1": float((e >= 1).mean())}
    return out


def layers(seeds):
    """llama3.2-1b's bfloat16 fixture recipe, op by op, on the CPU."""
    import jax.numpy as jnp
    import torch
    import test_torch_model as M
    from repro.launch.mesh import compat_make_mesh
    from repro.models import attention as RA
    from repro.models import layers as RL
    from repro_torch.models import attention as PA
    from repro_torch.models import layers as PL
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    rc, pc = M.fixture_config("llama3.2-1b", "bfloat16")
    b, s, hq, hd, eps = 1, M.FIXTURE_SEQ, pc.n_heads, pc.hd, pc.norm_eps
    bq, bk = (2048, 4096) if pc.attn_unroll else (512, 1024)
    J = M.ref_as_written

    def to_t(a):
        a = np.asarray(a)
        if a.dtype.itemsize == 2 and a.dtype != np.int16:    # bfloat16
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    def bits(a):
        if isinstance(a, torch.Tensor):
            return a.contiguous().view(torch.int16).numpy().view(np.uint16)
        return np.asarray(a).view(np.uint16)

    def mlp_gate(h, g):           # the reference's apply_mlp, between its products
        return h * M.jax.nn.silu(g.astype(jnp.float32)).astype(h.dtype)

    def rope64(q, k, pos):
        d = q.shape[-1]
        freqs = 1.0 / (pc.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d))
        ang = pos.double()[..., None] * freqs
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]

        def rot(x):
            x1, x2 = x[..., : d // 2].double(), x[..., d // 2:].double()
            return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return rot(q), rot(k)

    def attention64(q, k, v):
        rep = q.shape[1] // k.shape[1]
        kk = k.double().repeat_interleave(rep, 1)
        vv = v.double().repeat_interleave(rep, 1)
        sc = q.double() @ kk.transpose(-1, -2) / hd ** 0.5
        sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), -torch.inf)
        return torch.softmax(sc, -1) @ vv

    def ln64(x, g):
        x = x.double()
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g.double()

    # op -> (the reference's op on jnp arrays, the port's on tensors, the
    # exact op in float64 on the same inputs); every output is bfloat16
    ops = {
        "ln": (lambda x, g: RL.rms_norm(x, g, eps), lambda x, g: PL.rms_norm(x, g, eps),
               ln64),
        "proj": (lambda x, w: jnp.einsum("bsd,dh->bsh", x, w), PL.matmul,
                 lambda x, w: x.double() @ w.double()),
        "rope": (lambda q, k, pos: RA.rope(q, k, pos, rc.rope_theta),
                 lambda q, k, pos: PA.rope(q, k, pos, pc.rope_theta), rope64),
        "attention": (lambda q, k, v: RA.blockwise_attention(
                          q, k, v, causal=True, block_q=bq, block_k=bk),
                      lambda q, k, v: PA.blockwise_attention(
                          q, k, v, causal=True, block_q=bq, block_k=bk), attention64),
        "add": (lambda x, y: x + y, lambda x, y: x + y,
                lambda x, y: x.double() + y.double()),
        "gate": (mlp_gate,
                 lambda h, g: h * torch.nn.functional.silu(g.float()).to(h.dtype),
                 lambda h, g: h.double() * torch.nn.functional.silu(g.double())),
    }
    for seed in seeds:
        arrays = M.convert.seeded_model_arrays(pc, seed)
        rp, pp = M.ref_params(arrays), M.convert.model_params(arrays, "cpu")
        tok = M.fixture_tokens(pc, seed=seed)
        want_logits, _ = J(lambda p, t: M.RT.prefill(p, rc, M.REF_PLAN, mesh, t), rp,
                           {"tokens": jnp.asarray(tok)})
        pos_r = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
        pos_p = torch.arange(s)[None].expand(b, s)
        state = {}       # name -> (reference chain's value, port chain's value)

        def step(name, op, r_args, p_args, pick=None):
            """Run one op: the reference on its chain, the port on the
            reference's inputs and on its own chain; print both distances."""
            r_fn, p_fn, e_fn = ops[op]
            r_out = J(r_fn, *r_args)
            t_args = [to_t(a) for a in r_args]
            p_iso = p_fn(*t_args)
            e_out = e_fn(*t_args)
            p_out = p_fn(*p_args)
            outs = []
            for i, (r, pi, e, pc_) in enumerate(zip(*[
                    o if isinstance(o, tuple) else (o,)
                    for o in (r_out, p_iso, e_out, p_out)])):
                nm = name if pick is None else pick[i]
                state[nm] = (r, pc_)
                print(json.dumps({"seed": seed, "op": nm,
                                  **_op_stats(bits(pi), bits(r), e.numpy()),
                                  "chain": _op_stats(bits(pc_), bits(r))}), flush=True)
                outs.append((r, pc_))
            return outs

        lp_r = lambda i: M.jax.tree.map(lambda a: a[i], rp["layers"])   # noqa: E731
        emb_r = J(lambda e, t: e.astype(jnp.bfloat16)[t], rp["embed"], jnp.asarray(tok))
        emb_p = pp["embed"].to(torch.bfloat16)[torch.from_numpy(tok).long()]
        state["x"] = (emb_r, emb_p)
        print(json.dumps({"seed": seed, "op": "embedding",
                          **_op_stats(bits(emb_p), bits(emb_r))}), flush=True)
        for i in range(pc.n_layers):
            lr, lq = lp_r(i), M.PT._layer(pp["layers"], i)
            xr, xp = state["x"]
            (hr, hp), = step(f"L{i}.ln1", "ln", (xr, lr["ln1"]), (xp, lq["ln1"]))
            qkv = {}
            for w, nh in (("wq", hq), ("wk", pc.n_kv_heads), ("wv", pc.n_kv_heads)):
                (r, p), = step(f"L{i}.{w[1]}", "proj", (hr, lr["attn"][w]),
                               (hp, lq["attn"][w]))
                qkv[w] = (r.reshape(b, s, nh, hd).transpose(0, 2, 1, 3),
                          p.reshape(b, s, nh, hd).transpose(1, 2))
            (qr, qp), (kr, kp) = step(
                f"L{i}.rope", "rope", (qkv["wq"][0], qkv["wk"][0], pos_r),
                (qkv["wq"][1], qkv["wk"][1], pos_p),
                pick=(f"L{i}.rope_q", f"L{i}.rope_k"))
            (orr, op_), = step(f"L{i}.attention", "attention", (qr, kr, qkv["wv"][0]),
                               (qp, kp, qkv["wv"][1]))
            orr = orr.transpose(0, 2, 1, 3).reshape(b, s, hq * hd)
            op_ = op_.transpose(1, 2).reshape(b, s, hq * hd)
            (ar, ap), = step(f"L{i}.o_proj", "proj", (orr, lr["attn"]["wo"]),
                             (op_, lq["attn"]["wo"]))
            (xr, xp), = step(f"L{i}.residual1", "add", (xr, ar), (xp, ap))
            (h2r, h2p), = step(f"L{i}.ln2", "ln", (xr, lr["ln2"]), (xp, lq["ln2"]))
            (mir, mip), = step(f"L{i}.mlp_wi", "proj", (h2r, lr["mlp"]["wi"]),
                               (h2p, lq["mlp"]["wi"]))
            (mgr, mgp), = step(f"L{i}.mlp_wg", "proj", (h2r, lr["mlp"]["wg"]),
                               (h2p, lq["mlp"]["wg"]))
            (gr, gp), = step(f"L{i}.mlp_gate", "gate", (mir, mgr), (mip, mgp))
            (yr, yp), = step(f"L{i}.mlp_wo", "proj", (gr, lr["mlp"]["wo"]),
                             (gp, lq["mlp"]["wo"]))
            step(f"L{i}.residual2", "add", (xr, yr), (xp, yp), pick=("x",))
        xr, xp = state["x"]
        (fr, fp), = step("final_norm", "ln", (xr[:, -1:], rp["final_norm"]),
                         (xp[:, -1:], pp["final_norm"]))
        (lr_, lp_), = step("logits", "proj", (fr, rp["unembed"]), (fp, pp["unembed"]))
        want = bf16_bits_to_f32(np.asarray(want_logits).view(np.uint16))
        print(json.dumps({
            "seed": seed, "op": "prefill",
            "stepwise_ref_vs_ref_prefill": gaps(bf16_bits_to_f32(bits(lr_))[:, 0], want),
            "port_chain_vs_ref_prefill": gaps(bf16_bits_to_f32(bits(lp_))[:, 0], want)}),
            flush=True)


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
    ap.add_argument("mode", choices=["forward", "write", "prefill", "flash-seeds",
                                     "layers"])
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
    elif args.mode == "layers":
        layers(seeds)
    elif args.mode == "write":
        write(args.dir, seeds)
    else:
        prefill(args.dir, args.device)


if __name__ == "__main__":
    sys.exit(main())
