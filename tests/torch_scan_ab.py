"""Time the crossbar scan and the netsim replay (and the attention kernel at
llama3.2-1b's prefill) from one tree of the repo, so that two trees can be
compared on one card; ``--check`` also holds every scan form against its
plain version, bitwise, over a matrix of shapes.

    python3 tests/torch_scan_ab.py                   # this tree's package
    python3 tests/torch_scan_ab.py --src OTHER/src   # another tree's
    python3 tests/torch_scan_ab.py --check           # + the bitwise matrix

Run it from each tree in turns (A, B, B, A) in one run on the card.  It
measures (ms per call, CUDA events over back-to-back calls after a warm-up)
the five scan forms (xbar absolute float64 and slack float32; netsim
ungated and gated absolute float64, gated slack float32) at three of
``chip_smoke.py``'s kernels-phase shapes (``SCAN_SHAPES``): hft (B 48,
m 3,707, 8 ports), space480 (B 480) and datacenter (B 8, m 530, 32 ports),
on timelines from ``chip_smoke.timeline``, and ``flash_attention`` and SDPA
at llama3.2-1b's prefill.  Each scan form also gets ``kernel_ms``, the
device time of its kernel alone under ``torch.profiler`` (the wrapper's
``ms`` includes what the host does between launches, its port-id check
among it).  The matrix: n_ports 4, 8, 32, 40 and 300; m 1, 31, 33, 530 and
3,707; B 7 (not a multiple of the rows a block holds), its first row
admitting no event and its second every event.

Needs a CUDA card; prints the card's name and power limit, then one JSON
line per result.  Exits 1 if a form of the matrix disagrees.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports the standard
    library only)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
#: name -> (B, m, n_ports), from chip_smoke.py's kernels phase
SHAPES = {k: CS.SCAN_SHAPES[k] for k in ("hft", "datacenter", "space480")}
FORMS = ("xbar_abs_f64", "xbar_slack_f32", "netsim_ungated_abs_f64",
         "netsim_gated_abs_f64", "netsim_gated_slack_f32")
MATRIX_PORTS = (4, 8, 32, 40, 300)
MATRIX_M = (1, 31, 33, 530, 3707)
MATRIX_B = 7
#: kernel names of the scans in this tree and in the trees before it
SCAN_KERNELS = ("port_scan", "xbar_scan_kernel", "netsim_replay_kernel")


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_ms(torch, fn, reps):
    """Device time of the scan kernels alone per call, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages() if any(k in e.key for k in SCAN_KERNELS))
    return us / reps / 1e3


def form_calls(torch, dev, form, arrays, n):
    """(kernel call, plain call) of one form on one timeline."""
    from repro_torch.kernels.netsim import kernel as nk
    from repro_torch.kernels.netsim import ref as nref
    from repro_torch.kernels.xbar import kernel as xk
    from repro_torch.kernels.xbar import ref as xref
    t, src, dst, svc, pipe, admit = arrays
    absolute = form.endswith("f64")
    dtype = torch.float64 if absolute else torch.float32
    tdt = t if absolute else np.diff(t, prepend=0.0)
    T = lambda a: torch.tensor(a, dtype=dtype, device=dev)   # noqa: E731
    t_d, svc_d, pipe_d = T(tdt), T(svc), T(pipe)
    src_d, dst_d = torch.tensor(src, device=dev), torch.tensor(dst, device=dev)
    adm_d = torch.tensor(admit, device=dev)
    svc_t = svc_d.t().contiguous()
    adm_t = adm_d.t().to(torch.uint8).contiguous()
    if form.startswith("xbar"):
        plain = xref.xbar_contend_abs_ref if absolute else xref.xbar_contend_slack_ref
        return (lambda: xk.xbar_scan(t_d, src_d, dst_d, svc_t, n_ports=n, absolute=absolute),
                lambda: plain(t_d, src_d, dst_d, svc_d, n_ports=n))
    gated = "ungated" not in form
    kern = lambda: nk.netsim_replay(t_d, src_d, dst_d, svc_t, pipe_d,   # noqa: E731
                                    adm_t if gated else None, n_ports=n, absolute=absolute)
    if absolute:
        return kern, lambda: nref.netsim_replay_abs_ref(
            t_d, src_d, dst_d, svc_d, pipe_d, adm_d if gated else None, n_ports=n)
    return kern, lambda: nref.netsim_replay_slack_ref(t_d, src_d, dst_d, svc_d, pipe_d,
                                                      adm_d, n_ports=n)


def arrays_of(seed, m, n, b):
    """chip_smoke.py's seeded timeline in float64 (the slack forms take the
    gaps and values in float32)."""
    return CS.timeline(np.random.default_rng(seed), m, n, b, f64=True)


def time_scans(torch, dev, reps):
    for shape, (b, m, n) in SHAPES.items():
        arrays = arrays_of(0, m, n, b)
        for form in FORMS:
            kern, _ = form_calls(torch, dev, form, arrays, n)
            ms = cuda_ms(torch, kern, reps)
            k_ms = kernel_ms(torch, kern, reps)
            print(json.dumps({"form": form, "shape": shape, "B": b, "m": m, "n_ports": n,
                              "ms": ms, "kernel_ms": k_ms,
                              "ns_per_event": k_ms * 1e6 / m}), flush=True)


def check_matrix(torch, dev):
    ok = True
    for n in MATRIX_PORTS:
        for m in MATRIX_M:
            t, src, dst, svc, pipe, admit = arrays_of(n * 10_000 + m, m, n, MATRIX_B)
            admit[0] = False
            admit[1] = True
            for form in FORMS:
                kern, plain = form_calls(torch, dev, form, (t, src, dst, svc, pipe, admit), n)
                got, want = kern(), plain()
                torch.cuda.synchronize()
                equal = bool(torch.equal(got, want))
                ok &= equal
                if not equal:
                    print(json.dumps({"check": form, "n_ports": n, "m": m, "B": MATRIX_B,
                                      "bitwise_equal": False,
                                      "max_abs_err": float((got - want).abs().max())}),
                          flush=True)
    print(json.dumps({"check": "matrix", "forms": len(FORMS),
                      "n_ports": MATRIX_PORTS,
                      "m": MATRIX_M, "B": MATRIX_B, "all_bitwise_equal": ok}), flush=True)
    return ok


def time_flash(torch, dev, reps):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    b, hq, hkv, s, d = 4, 32, 8, 8192, 64            # chip_smoke.py's llama_prefill
    g = torch.Generator(dev).manual_seed(s + hq)
    q = torch.randn((b, hq, s, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, hkv, s, d), generator=g, device=dev).bfloat16()
    v = torch.randn((b, hkv, s, d), generator=g, device=dev).bfloat16()
    print(json.dumps({"form": "flash_llama_prefill", "ms": cuda_ms(
        torch, lambda: fk.flash_attention(q, k, v, causal=True), reps),
        "sdpa_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps)}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(REPO, "src"),
                    help="the directory holding the repro_torch package to time")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_scan_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(card(), flush=True)
    print(json.dumps({"src": os.path.abspath(args.src)}), flush=True)
    ok = check_matrix(torch, dev) if args.check else True
    time_scans(torch, dev, args.reps)
    time_flash(torch, dev, args.reps)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
