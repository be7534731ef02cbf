#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases kernels   # a subset (device and build always run)

Phases, one result line each; any failure exits non-zero without the final
``{"ok": true, ...}`` line:

  device   the card's name and power limit (nvidia-smi).
  build    compile the hand-written kernels (one nvcc per source, together).
  kernels  each kernel in each form (xbar absolute float64 and slack
           float32; netsim ungated and gated absolute float64, gated slack
           float32) against its plain PyTorch version on the card, bitwise
           (torch.equal), at the DSE's shapes; ms per call for both.
  path     run_dse on the card for hft, datacenter, hft_nsga2 and
           hft_codesign with the settings their golden reports record
           (tests/golden/*.json), compared with those reports under the
           golden harness's rules (restated below), with both kernels'
           launch counters set to 0 before and read after.
  scale    run_dse on a 40 ms hft capture (~372k events) and evaluate_space
           on a 10 ms one (~93k events, 480 candidate rows), with two
           candidates of each held bitwise against the serial run_surrogate /
           run_netsim; per-stage wall time, kernel ms, peak device memory.

Needs no network and imports nothing of JAX or of the JAX package ``repro``.
Exits non-zero when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("kernels", "path", "scale")
GOLDEN = ("hft", "datacenter", "hft_nsga2", "hft_codesign")

#: H100 SXM peaks used for bounds: HBM bandwidth and non-tensor FP64/FP32
#: (NVIDIA's data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {8: 34e12, 4: 67e12}


# --------------------------------------------------------------------------
# the golden harness's comparison rules (tests/test_golden.py diff_reports)
# --------------------------------------------------------------------------
# timing fields (*_time_s) are skipped; floats under a key containing
# "latency" or "throughput", and "hypervolume=" stage notes, compare with
# rtol 1e-6 (inf only equals inf); everything else — candidate shorts,
# drops, resources, stage logs, counts — compares exactly.

RTOL_KEYS = ("latency", "throughput")
RTOL = 1e-6
VOLATILE = ("wall_time_s", "stage2_time_s", "stage4_time_s")


def _close(a, b) -> bool:
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= RTOL * max(abs(a), abs(b), 1e-300)


def diff_reports(got, want, path="report", key="", errors=None):
    errors = [] if errors is None else errors
    if isinstance(want, dict):
        if not isinstance(got, dict):
            errors.append(f"{path}: expected dict, got {type(got).__name__}")
            return errors
        missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
        if missing:
            errors.append(f"{path}: missing keys {missing}")
        if extra:
            errors.append(f"{path}: unexpected keys {extra}")
        for k in sorted(set(want) & set(got)):
            if k not in VOLATILE:
                diff_reports(got[k], want[k], f"{path}.{k}", k, errors)
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            errors.append(f"{path}: length mismatch")
            return errors
        for i, (g, w) in enumerate(zip(got, want)):
            diff_reports(g, w, f"{path}[{i}]", key, errors)
    elif isinstance(want, str) and want.startswith("hypervolume="):
        if not (isinstance(got, str) and got.startswith("hypervolume=")
                and _close(float(got.split("=", 1)[1]),
                           float(want.split("=", 1)[1]))):
            errors.append(f"{path}: {got!r} !~ {want!r}")
    elif (isinstance(want, float) and not isinstance(want, bool)
          and any(t in key for t in RTOL_KEYS)):
        if not (isinstance(got, (int, float)) and _close(float(got), want)):
            errors.append(f"{path}: {got!r} !~ {want!r} (rtol={RTOL})")
    elif got != want:
        errors.append(f"{path}: {got!r} != {want!r}")
    return errors


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, sort_keys=True), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()                                   # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def wall_ms(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def timeline(rng, m: int, n_ports: int, b: int, *, f64: bool):
    """Seeded inputs at one shape: a sorted timeline with real contention
    (mean gap below the mean service time), ports, service times, pipeline
    latencies and ~90 % admissions."""
    import numpy as np
    gaps = rng.exponential(2e-8, m)
    gaps[0] = 0.0
    t = np.cumsum(gaps)
    src = rng.integers(0, n_ports, m).astype(np.int32)
    dst = rng.integers(0, n_ports, m).astype(np.int32)
    svc = rng.uniform(1e-8, 8e-8, (b, m))
    pipe = rng.uniform(1e-8, 5e-8, b)
    admit = rng.random((b, m)) < 0.9
    if not f64:
        return (np.diff(t, prepend=0.0).astype(np.float32), src, dst,
                svc.astype(np.float32), pipe.astype(np.float32), admit)
    return t, src, dst, svc, pipe, admit


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_kernels(dev, stats):
    """Each kernel form against its plain version, bitwise, at path shapes."""
    import numpy as np
    import torch
    from repro_torch.kernels.netsim import kernel as nk
    from repro_torch.kernels.netsim import ref as nref
    from repro_torch.kernels.xbar import kernel as xk
    from repro_torch.kernels.xbar import ref as xref

    shapes = {"hft": (48, 3707, 8), "datacenter": (8, 530, 32),
              "space480": (480, 3707, 8)}
    ok = True
    for shape, (b, m, n) in shapes.items():
        rng = np.random.default_rng(0)
        for f64 in (True, False):
            t, src, dst, svc, pipe, admit = timeline(rng, m, n, b, f64=f64)
            T = lambda a: torch.tensor(a, device=dev)      # noqa: E731
            t_d, src_d, dst_d, svc_d = T(t), T(src), T(dst), T(svc)
            svc_t = svc_d.t().contiguous()
            pipe_d, adm_d = T(pipe), T(admit)
            adm_t = adm_d.t().to(torch.uint8).contiguous()
            if f64:
                forms = {
                    "xbar_abs_f64": (
                        lambda: xk.xbar_scan(t_d, src_d, dst_d, svc_t,
                                             n_ports=n, absolute=True),
                        lambda: xref.xbar_contend_abs_ref(
                            t_d, src_d, dst_d, svc_d, n_ports=n)),
                    "netsim_ungated_abs_f64": (
                        lambda: nk.netsim_replay(t_d, src_d, dst_d, svc_t,
                                                 pipe_d, None, n_ports=n,
                                                 absolute=True),
                        lambda: nref.netsim_replay_abs_ref(
                            t_d, src_d, dst_d, svc_d, pipe_d, None,
                            n_ports=n)),
                    "netsim_gated_abs_f64": (
                        lambda: nk.netsim_replay(t_d, src_d, dst_d, svc_t,
                                                 pipe_d, adm_t, n_ports=n,
                                                 absolute=True),
                        lambda: nref.netsim_replay_abs_ref(
                            t_d, src_d, dst_d, svc_d, pipe_d, adm_d,
                            n_ports=n)),
                }
            else:
                forms = {
                    "xbar_slack_f32": (
                        lambda: xk.xbar_scan(t_d, src_d, dst_d, svc_t,
                                             n_ports=n, absolute=False),
                        lambda: xref.xbar_contend_slack_ref(
                            t_d, src_d, dst_d, svc_d, n_ports=n)),
                    "netsim_gated_slack_f32": (
                        lambda: nk.netsim_replay(t_d, src_d, dst_d, svc_t,
                                                 pipe_d, adm_t, n_ports=n,
                                                 absolute=False),
                        lambda: nref.netsim_replay_slack_ref(
                            t_d, src_d, dst_d, svc_d, pipe_d, adm_d,
                            n_ports=n)),
                }
            for form, (kern, plain) in forms.items():
                got = kern()
                want = plain()
                torch.cuda.synchronize()
                equal = bool(torch.equal(got, want))
                err = float((got.double() - want.double()).abs().max())
                k_ms = cuda_ms(kern, reps=5)
                p_ms = wall_ms(plain)
                item = size = got.element_size()
                gated = "gated" in form
                netsim = form.startswith("netsim")
                moved = (b * m * size * 2 + m * (size + 8)
                         + (b * size if netsim else 0) + (b * m if gated else 0))
                flops = b * m * (4 if netsim else 3)
                bound = max(moved / HBM_BYTES_PER_S,
                            flops / PEAK_FLOPS[item]) * 1e3
                rec = {"shape": shape, "B": b, "m": m, "n_ports": n,
                       "form": form, "bitwise_equal": equal,
                       "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                       "bound_ms": bound,
                       "bound_by": ("bytes" if moved / HBM_BYTES_PER_S
                                    >= flops / PEAK_FLOPS[item]
                                    else "operations"),
                       "ns_per_event": k_ms * 1e6 / m}
                stats["forms"].append(rec)
                say("kernels", **rec)
                ok &= equal
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version")


def _counters():
    from repro_torch.kernels.netsim import kernel as nk
    from repro_torch.kernels.xbar import kernel as xk
    return xk, nk


def phase_path(dev, stats):
    """run_dse on the card vs the golden reports, with launch counts."""
    from repro_torch.convert import report_dict, switch_problem_from_dict
    from repro_torch.core.dse import run_dse

    xk, nk = _counters()
    xk.LAUNCHES = 0
    nk.LAUNCHES = 0
    failures = []
    for name in GOLDEN:
        with open(os.path.join(ROOT, "tests", "golden", f"{name}.json")) as f:
            want = json.load(f)
        x0, n0 = xk.LAUNCHES, nk.LAUNCHES
        t0 = time.perf_counter()
        problem, sla, budget, kw = switch_problem_from_dict(
            want["scenario"], device=dev)
        result = run_dse(problem, sla, budget, **kw)
        wall = time.perf_counter() - t0
        got = json.loads(json.dumps(report_dict(problem, result)))
        errors = diff_reports(got, {k: want[k] for k in got})
        say("path", scenario=name, best=got["best"], mismatches=len(errors),
            first_mismatches=errors[:5], wall_s=wall,
            xbar_launches=xk.LAUNCHES - x0, netsim_launches=nk.LAUNCHES - n0)
        if errors:
            failures.append(name)
    stats["launches"] = {"xbar_scan": xk.LAUNCHES,
                         "netsim_replay": nk.LAUNCHES}
    say("path", launches=stats["launches"])
    if failures:
        raise AssertionError(f"golden mismatch: {failures}")
    if not (xk.LAUNCHES > 0 and nk.LAUNCHES > 0):
        raise AssertionError(f"a kernel did not run on the main path: "
                             f"{stats['launches']}")


def _timed(problem, name, log):
    """Wrap one batched hook of ``problem`` to record its wall time and
    what it returned (for the serial spot checks)."""
    import torch
    fn = getattr(problem, name)

    def wrapped(cands):
        cands = list(cands)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(cands)
        torch.cuda.synchronize()
        log.setdefault(name, []).append(
            (time.perf_counter() - t0, cands, out))
        return out
    setattr(problem, name, wrapped)


def _spot_stage2(problem, cands, srs, picks):
    import numpy as np
    from repro_torch.sim.surrogate import run_surrogate
    for k in picks:
        c, rb = cands[k], srs[k]
        rs = run_surrogate(problem._arch(c), problem._bound_for(c),
                           problem.trace, back_annotation=False,
                           i_burst=problem.features.i_burst)
        np.testing.assert_array_equal(rb.latency_ns, rs.latency_ns)
        np.testing.assert_array_equal(rb.q_occupancy, rs.q_occupancy)
        a, s = rb.meta["shared_occupancy"], rs.meta["shared_occupancy"]
        assert (a is None) == (s is None)
        if a is not None:
            np.testing.assert_array_equal(a, s)


def _spot_stage4(problem, cands, vs, picks):
    import numpy as np
    from repro_torch.sim.netsim import run_netsim
    for k in picks:
        c, vb = cands[k], vs[k]
        s = run_netsim(problem._arch(c), problem._bound_for(c), problem.trace,
                       back_annotation=False, i_burst=problem.features.i_burst)
        assert vb.drop_rate == s.drop_rate
        assert vb.p99_latency_ns == s.p99_latency_ns
        assert vb.mean_latency_ns == s.mean_latency_ns
        assert vb.throughput_gbps == s.throughput_gbps
        np.testing.assert_array_equal(vb.meta["latency_ns"], s.meta["latency_ns"])


def host_passes(problem, dev, rng, b):
    """Wall time of each host pass of stages 2 and 4, run alone at this
    cell's shape (the stage walls are mostly made of these).  Departures
    come from the xbar kernel on the cell's own timeline, so they are FIFO
    per chain as the stage-2 engine's are."""
    import numpy as np
    import torch
    from repro_torch.kernels.netsim import segmented_occupancy
    from repro_torch.kernels.xbar import kernel as xk
    from repro_torch.sim.netsim import switch_arrival_times
    from repro_torch.sim.timeline import stage2_timeline

    tr = problem.trace
    n = problem.request.n_ports
    tl2 = stage2_timeline(tr, n)
    m = tl2.t.size
    svc = rng.uniform(5e-9, 6e-8, (b, m))
    T = lambda a: torch.tensor(a, device=dev)              # noqa: E731
    dep = xk.xbar_scan(T(tl2.t), T(tl2.src.astype(np.int32)),
                       T(tl2.dst.astype(np.int32)), T(svc).t().contiguous(),
                       n_ports=n, absolute=True).cpu().numpy()

    def wall(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    lat = (dep - tl2.t[None, :] + 1e-8) * 1e9
    wire = np.asarray(tr.payload_bytes, np.int64) + problem.bound.header_bytes
    return {
        "stage2_service_time_rows": wall(lambda: [
            (np.maximum(1, -(-(tl2.payload + 3) // 32)) + 0.3) / 2e8
            for _ in range(b)]),
        "stage2_latency_matrix": wall(
            lambda: (dep - tl2.t[None, :] + 1e-8) * 1e9),
        "stage2_percentiles": wall(
            lambda: np.percentile(lat, (50.0, 90.0, 99.0), axis=1)),
        "stage2_segmented_occupancy": wall(
            lambda: segmented_occupancy(tl2.t, dep, tl2.chain)),
        "stage4_switch_arrival_times": wall(lambda: switch_arrival_times(
            np.asarray(tr.time_s, np.float64),
            np.asarray(tr.src, np.int64) % n, wire, tr.link_gbps * 1e9, 0.0,
            n)),
    }


def phase_scale(dev, stats):
    """Real capture lengths: 372k-event DSE and the 480-row space screen."""
    import numpy as np
    import torch
    from repro_torch.convert import switch_problem_from_dict
    from repro_torch.core.dse import run_dse
    from repro_torch.core.search import evaluate_space
    from repro_torch.kernels.netsim import kernel as nk
    from repro_torch.kernels.xbar import kernel as xk

    with open(os.path.join(ROOT, "tests", "golden", "hft.json")) as f:
        scen = json.load(f)["scenario"]

    # (a) the exhaustive DSE on a 40 ms capture
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    problem, sla, budget, kw = switch_problem_from_dict(
        scen, device=dev, trace_params={"duration_s": 0.04})
    t_build = time.perf_counter() - t0
    log = {}
    _timed(problem, "surrogate_batch", log)
    _timed(problem, "verify_batch", log)
    x0, n0 = xk.LAUNCHES, nk.LAUNCHES
    t1 = time.perf_counter()
    result = run_dse(problem, sla, budget, **kw)
    t_dse = time.perf_counter() - t1
    launches = {"xbar_scan": xk.LAUNCHES - x0, "netsim_replay": nk.LAUNCHES - n0}
    (s2, c2, r2), = log["surrogate_batch"]
    (s4, c4, r4), = log["verify_batch"]
    m = len(problem.trace)
    t2 = time.perf_counter()
    _spot_stage2(problem, c2, r2, [0, len(c2) - 1])
    _spot_stage4(problem, c4, r4, [0, len(c4) - 1])
    t_spot = time.perf_counter() - t2
    rng = np.random.default_rng(1)
    t, src, dst, svc, pipe, _ = timeline(rng, m, 8, len(c2), f64=True)
    T = lambda a: torch.tensor(a, device=dev)              # noqa: E731
    t_d, src_d, dst_d, pipe_d = T(t), T(src), T(dst), T(pipe)
    svc_t = T(svc).t().contiguous()
    x_ms = cuda_ms(lambda: xk.xbar_scan(t_d, src_d, dst_d, svc_t, n_ports=8,
                                        absolute=True), reps=2)
    n_ms = cuda_ms(lambda: nk.netsim_replay(t_d, src_d, dst_d, svc_t, pipe_d,
                                            None, n_ports=8, absolute=True),
                   reps=2)
    host = host_passes(problem, dev, rng, len(c2))
    rec = {"run": "run_dse hft duration_s=0.04", "events": m,
           "stage2_rows": len(c2), "stage4_rows": len(c4),
           "best": result.best.short() if result.best is not None else None,
           "trace_and_problem_s": t_build, "run_dse_s": t_dse,
           "stage2_s": s2, "stage4_s": s4,
           "stage1_3_and_rest_s": t_dse - s2 - s4,
           "xbar_ms_at_this_shape": x_ms, "netsim_round1_ms_at_this_shape": n_ms,
           "launches": launches, "host_passes_alone_s": host,
           "serial_spot_checks": "bitwise", "serial_spot_checks_s": t_spot,
           "peak_device_mb": torch.cuda.max_memory_allocated(dev) / 2**20}
    stats["scale"].append(rec)
    say("scale", **rec)
    del problem, result, log, svc_t, t_d, src_d, dst_d, pipe_d

    # (b) the exhaustive space screen on a 10 ms capture
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    problem, sla, _, kw = switch_problem_from_dict(
        scen, device=dev, trace_params={"duration_s": 0.01})
    t_build = time.perf_counter() - t0
    log = {}
    _timed(problem, "surrogate_batch", log)
    t1 = time.perf_counter()
    ev = evaluate_space(problem, sla, delta=kw["delta"])
    t_eval = time.perf_counter() - t1
    (s2, c2, r2), = log["surrogate_batch"]
    m = len(problem.trace)
    t, src, dst, svc, _, _ = timeline(rng, m, 8, len(c2), f64=True)
    t_d, src_d, dst_d = T(t), T(src), T(dst)
    svc_t = T(svc).t().contiguous()
    x_ms = cuda_ms(lambda: xk.xbar_scan(t_d, src_d, dst_d, svc_t, n_ports=8,
                                        absolute=True), reps=2)
    del t_d, src_d, dst_d, svc_t
    t2 = time.perf_counter()
    _spot_stage2(problem, c2, r2, [0, len(c2) - 1])
    t_spot = time.perf_counter() - t2
    rec = {"run": "evaluate_space hft duration_s=0.01",
           "events": len(problem.trace), "stage2_rows": ev.surrogate_rows,
           "genomes": ev.n_genomes, "valid": len(ev.valid),
           "trace_and_problem_s": t_build, "evaluate_space_s": t_eval,
           "stage2_s": s2, "xbar_ms_at_this_shape": x_ms,
           "serial_spot_checks": "bitwise",
           "serial_spot_checks_s": t_spot,
           "peak_device_mb": torch.cuda.max_memory_allocated(dev) / 2**20}
    stats["scale"].append(rec)
    say("scale", **rec)


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

KERNELS = {
    "xbar_scan": {"source": "src/repro_torch/csrc/xbar.cu",
                  "replaces": "src/repro/kernels/xbar/kernel.py:54",
                  "form": "xbar_abs_f64"},
    "netsim_replay": {"source": "src/repro_torch/csrc/netsim.cu",
                      "replaces": "src/repro/kernels/netsim/kernel.py:62",
                      "form": "netsim_ungated_abs_f64"},
}


def kernels_line(stats):
    """One entry per kernel: the main-path form at the hft shape, the
    largest disagreement over every form and shape, and the path's launches."""
    out = []
    for name, meta in KERNELS.items():
        forms = [r for r in stats["forms"] if r["form"].startswith(name.split("_")[0])]
        main = next((r for r in forms if r["form"] == meta["form"]
                     and r["shape"] == "hft"), {})
        out.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": stats.get("launches", {}).get(name, 0),
            "max_abs_err": max((r["max_abs_err"] for r in forms), default=None),
            "ms": main.get("ms"), "plain_ms": main.get("plain_ms"),
            "bound_ms": main.get("bound_ms"), "bound_by": main.get("bound_by"),
            "library_ms": None,
        })
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    say("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    from repro_torch.kernels.build import BUILD_DIR, build_all
    t0 = time.perf_counter()
    try:
        libs = build_all()
    except RuntimeError:
        traceback.print_exc()
        return 1
    regs = {}
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            regs[name] = [ln.strip() for ln in log.read_text().splitlines()
                          if "registers" in ln]
    say("build", seconds=time.perf_counter() - t0, build_dir=str(BUILD_DIR),
        ptxas=regs)

    stats = {"forms": [], "scale": []}
    failed = []
    for name, fn in (("kernels", phase_kernels), ("path", phase_path),
                     ("scale", phase_scale)):
        if name not in phases:
            continue
        t0 = time.perf_counter()
        try:
            fn(dev, stats)
            say(name, status="ok", seconds=time.perf_counter() - t0)
        except Exception:                  # report every phase, then fail
            traceback.print_exc()
            say(name, status="FAILED", seconds=time.perf_counter() - t0)
            failed.append(name)
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    print(nvidia_smi())
    print(json.dumps(kernels_line(stats)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
