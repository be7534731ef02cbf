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
           float32; iSLIP at 8 and 32 ports, 1-4 iterations, batches of 1
           and 4096; the header parser on the hft and datacenter protocols
           at 9,600 and 1,048,576 headers) against its plain PyTorch version
           on the card, bitwise (torch.equal), at the DSE's shapes; ms per
           call for both, and the bound.
  path     two main paths, each with every kernel's launch counter set to 0
           just before and read just after:
           (a) run_scenario on the card for hft, datacenter, hft_nsga2 and
           hft_codesign with the settings their golden reports record
           (tests/golden/*.json), compared with those reports under the
           golden harness's rules (restated below); xbar and netsim must
           launch;
           (b) run_scenario for hft and datacenter (its trace cut to
           200 µs) at the registry's defaults (back-annotation on: the
           cycle-level switch calibrates the scheduler efficiency) with
           verify_engine="auto" (the champion escalated to the cycle-level
           switch), compared with the
           JAX package's runs recorded in tests/torch_golden/: the report,
           the escalated cycle result exactly, and the calibrated η; islip
           and parser must launch.  Stage walls, calibration and rung-4
           walls.
  scale    run_dse on a 40 ms hft capture (~372k events) and evaluate_space
           on a 10 ms one (~93k events, 480 candidate rows), with two
           candidates of each held bitwise against the serial run_surrogate /
           run_netsim; per-stage wall time, kernel ms, peak device memory.
  profile  (only when named) the cycle-level switch's loop under
           torch.profiler: kernel launches per simulated cycle, the device's
           busy share, and device time by kernel, for hft's iSLIP
           calibration run and 2,000 cycles of its rung-4 champion.

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
#: phases that run only when named with --phases
OPTIONAL_PHASES = ("profile",)
GOLDEN = ("hft", "datacenter", "hft_nsga2", "hft_codesign")
#: the cycle-level switch's runs, tests/torch_golden/<name>.{json,npz}:
#: (registry entry, trace overrides); datacenter's trace is cut from 800 to
#: 200 µs (149,546 -> 24,203 rung-4 cycles) to keep this script well inside
#: its time limit
SWITCH_RUNS = {"hft_auto": ("hft", None),
               "datacenter_auto": ("datacenter", {"duration_s": 2e-4})}
SIM_ARRAYS = ("latency_cycles", "latency_ns", "occ_max", "occ_trace")

#: H100 SXM peaks used for bounds: HBM bandwidth and non-tensor FP64/FP32
#: (NVIDIA's data sheet, at the 700 W power limit); 32-bit integer work is
#: bounded by the float32 rate, which no integer pipe exceeds
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
                rec = {"kernel": "netsim_replay" if netsim else "xbar_scan",
                       "shape": shape, "B": b, "m": m, "n_ports": n,
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
    ok &= kernels_islip(dev, stats)
    ok &= kernels_parser(dev, stats)
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version")


def _record(stats, rec, got, want):
    """Compare a kernel's outputs with its plain version's; log the form."""
    import torch
    equal = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    rec["bitwise_equal"] = equal
    rec["max_abs_err"] = max(float((g.double() - w.double()).abs().max())
                             if g.numel() else 0.0 for g, w in zip(got, want))
    stats["forms"].append(rec)
    say("kernels", **rec)
    return equal


def _bound(moved, ops, item):
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, ops / PEAK_FLOPS[item]
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def kernels_islip(dev, stats):
    """iSLIP at the switch's widths, batches of 1 (the cycle loop) and 4096."""
    import numpy as np
    import torch
    from repro_torch.kernels.islip import kernel as ik
    from repro_torch.kernels.islip.ref import islip_ref

    ok = True
    rng = np.random.default_rng(0)
    for n in (8, 32):
        for iters in (1, 2, 3, 4):
            for b in (1, 4096):
                T = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
                req = T(rng.integers(0, 2, (b, n, n)))
                g, a = T(rng.integers(0, n, (b, n))), T(rng.integers(0, n, (b, n)))
                kern = lambda: ik.islip_launch(req, g, a, iters=iters)  # noqa: E731
                plain = lambda: islip_ref(req, g, a, iters=iters)      # noqa: E731
                got, want = kern(), plain()
                torch.cuda.synchronize()
                # read req and both pointers, write match and both pointers;
                # each round compares and selects over the N x N matrix twice
                moved = b * (2 * n * n + 4 * n) * 4
                ops = b * iters * 4 * n * n
                bound, by = _bound(moved, ops, 4)
                rec = {"kernel": "islip_schedule", "form": f"islip_n{n}_it{iters}",
                       "shape": f"B{b}", "B": b, "n_ports": n, "iters": iters,
                       "ms": cuda_ms(kern, reps=200 if b == 1 else 20),
                       "plain_ms": wall_ms(plain), "bound_ms": bound,
                       "bound_by": by}
                ok &= _record(stats, rec, got, want)
    return ok


def kernels_parser(dev, stats):
    """The header parser on the hft and datacenter protocols: the switch's
    calibration trace (9,600 headers) and a million headers."""
    import numpy as np
    import torch
    from repro_torch.api import build_bound, registry
    from repro_torch.kernels.parser import bake_slices, parse_headers, parse_ref
    from repro_torch.kernels.parser import kernel as pk
    from repro_torch.switch.parser import pack_header_words

    ok = True
    rng = np.random.default_rng(1)
    for name in ("hft", "datacenter"):
        proto = build_bound(registry[name]).protocol
        fields = [f.name for f in proto.fields]
        for b in (9600, 1048576):
            vals = {f.name: rng.integers(0, 2 ** f.bits, b, dtype=np.uint64)
                    for f in proto.fields}
            words = torch.from_numpy(pack_header_words(proto, vals)).to(dev)
            baked = bake_slices(proto, fields)
            table, first = pk.slice_table(baked, dev)
            w, f = words.shape[1], len(fields)
            kern = lambda: pk.parse_words(words, table, first, n_words=w)  # noqa: E731
            plain = lambda: parse_ref(proto, fields, words)      # noqa: E731
            n0 = pk.LAUNCHES
            got, want = parse_headers(proto, fields, words), plain()
            torch.cuda.synchronize()
            assert pk.LAUNCHES == n0 + 1, "parse_headers did not launch the kernel"
            pieces = sum(len(p) for p in baked)
            bound, by = _bound(b * (w + f) * 4, b * pieces * 4, 4)
            rec = {"kernel": "parse_headers", "form": f"parser_{name}",
                   "shape": f"B{b}", "B": b, "words": w, "fields": f,
                   "ms": cuda_ms(kern, reps=20), "plain_ms": wall_ms(plain),
                   "bound_ms": bound, "bound_by": by}
            ok &= _record(stats, rec, (got,), (want,))
    return ok


def _counters():
    from repro_torch.kernels.islip import kernel as ik
    from repro_torch.kernels.netsim import kernel as nk
    from repro_torch.kernels.parser import kernel as pk
    from repro_torch.kernels.xbar import kernel as xk
    return {"xbar_scan": xk, "netsim_replay": nk, "islip_schedule": ik,
            "parse_headers": pk}


def _reset_counters():
    for mod in _counters().values():
        mod.LAUNCHES = 0


def _read_counters():
    return {name: mod.LAUNCHES for name, mod in _counters().items()}


def phase_path(dev, stats):
    """Two main paths on the card, each with fresh launch counters."""
    failures = path_golden(dev, stats) + path_switch(dev, stats)
    if failures:
        raise AssertionError(f"path failures: {failures}")


def path_golden(dev, stats):
    """(a) run_scenario vs the golden reports; xbar and netsim must launch."""
    from repro_torch.api import Scenario, run_scenario

    failures = []
    _reset_counters()
    for name in GOLDEN:
        with open(os.path.join(ROOT, "tests", "golden", f"{name}.json")) as f:
            want = json.load(f)
        before = _read_counters()
        report = run_scenario(Scenario.from_dict(want["scenario"]), device=dev)
        got = json.loads(json.dumps(report.to_dict()))
        errors = diff_reports(got, want)
        after = _read_counters()
        say("path", scenario=name, best=got["best"], mismatches=len(errors),
            first_mismatches=errors[:5], wall_s=report.wall_time_s,
            stage2_s=report.stage2_time_s, stage4_s=report.stage4_time_s,
            launches={k: after[k] - before[k] for k in after})
        if errors:
            failures.append(name)
    launches = _read_counters()
    stats["launches"].update({k: launches[k] for k in ("xbar_scan", "netsim_replay")})
    say("path", path="golden", launches=launches)
    if not (launches["xbar_scan"] > 0 and launches["netsim_replay"] > 0):
        failures.append(f"xbar/netsim did not run on the golden path: {launches}")
    return failures


def _timed_simulate(log):
    """Wrap the cycle-level switch to log each run's wall time and cycles
    (calibration runs pass max_cycles; rung 4 does not)."""
    import torch
    import repro_torch.switch.switch as sw
    real = sw.simulate

    def simulate(arch, bound, trace, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real(arch, bound, trace, **kw)
        torch.cuda.synchronize()
        log.append({"what": ("calibration" if kw.get("max_cycles") is not None
                             else "rung4"),
                    "arch": arch.short(), "cycles": res.n_cycles,
                    "packets": res.offered, "wall_s": time.perf_counter() - t0})
        return res
    sw.simulate = simulate
    return real


def _check_switch_run(name, report, eta_cache):
    """The report, the escalated cycle result and η against the JAX
    package's run recorded in tests/torch_golden/<name>.*"""
    import numpy as np
    base = os.path.join(ROOT, "tests", "torch_golden", name)
    with open(base + ".json") as f:
        want = json.load(f)
    errors = diff_reports(json.loads(json.dumps(report.to_dict())), want["report"])
    res = report.best_verify.meta["escalated"].meta["cycle"]
    scalars = {k: getattr(res, k) for k in want["escalated"]}
    if json.loads(json.dumps(scalars)) != want["escalated"]:
        errors.append(f"escalated scalars {scalars} != {want['escalated']}")
    with np.load(base + ".npz") as z:
        for k in SIM_ARRAYS:
            if not np.array_equal(getattr(res, k), z[k]):
                errors.append(f"escalated {k} differs")
    eta = [[k[0].value, k[1], k[2].value, k[3], v] for k, v in eta_cache.items()]
    if eta != want["eta_cache"]:
        errors.append(f"eta {eta} != {want['eta_cache']}")
    return errors, res


def path_switch(dev, stats):
    """(b) the registry's defaults (back-annotation) with the champion
    escalated to the cycle-level switch; islip and parser must launch."""
    import repro_torch.switch.switch as sw
    from repro_torch.api import registry, run_scenario
    from repro_torch.sim import backannotate

    failures = []
    log = []
    real = _timed_simulate(log)
    try:
        _reset_counters()
        for name, (scen, trace_params) in SWITCH_RUNS.items():
            backannotate._ETA_CACHE.clear()        # each run calibrates afresh
            before, n_log = _read_counters(), len(log)
            report = run_scenario(registry[scen].override(
                verify_engine="auto", trace_params=trace_params), device=dev)
            errors, res = _check_switch_run(name, report, backannotate._ETA_CACHE)
            after = _read_counters()
            runs = log[n_log:]
            calib = [r for r in runs if r["what"] == "calibration"]
            rung4 = [r for r in runs if r["what"] == "rung4"]
            rec = {"run": name, "best": report.to_dict()["best"],
                   "mismatches": len(errors), "first_mismatches": errors[:5],
                   "wall_s": report.wall_time_s,
                   "stage2_s": report.stage2_time_s,
                   "stage4_s": report.stage4_time_s,
                   "calibration_s": sum(r["wall_s"] for r in calib),
                   "calibration_cycles": sum(r["cycles"] for r in calib),
                   "calibration_families": len(calib),
                   "rung4_s": sum(r["wall_s"] for r in rung4),
                   "rung4_cycles": res.n_cycles, "rung4_events": res.offered,
                   "us_per_cycle": 1e6 * sum(r["wall_s"] for r in runs)
                   / max(sum(r["cycles"] for r in runs), 1),
                   "simulate_runs": runs,
                   "launches": {k: after[k] - before[k] for k in after}}
            stats["switch"].append(rec)
            say("path", **rec)
            if errors:
                failures.append(name)
        launches = _read_counters()
    finally:
        sw.simulate = real
    stats["launches"].update({k: launches[k]
                              for k in ("islip_schedule", "parse_headers")})
    say("path", path="switch", launches=launches)
    if not (launches["islip_schedule"] > 0 and launches["parse_headers"] > 0):
        failures.append(f"islip/parser did not run on the switch path: {launches}")
    return failures


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
    from repro_torch.api import Scenario, build_problem
    from repro_torch.core.dse import run_dse
    from repro_torch.core.search import evaluate_space
    from repro_torch.kernels.netsim import kernel as nk
    from repro_torch.kernels.xbar import kernel as xk

    with open(os.path.join(ROOT, "tests", "golden", "hft.json")) as f:
        scen = Scenario.from_dict(json.load(f)["scenario"])
    kw = {"delta": scen.fidelity.delta, "top_k": scen.fidelity.top_k}

    # (a) the exhaustive DSE on a 40 ms capture
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    problem, sla, budget = build_problem(
        scen.override(trace_params={"duration_s": 0.04}), device=dev)
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
    problem, sla, _ = build_problem(
        scen.override(trace_params={"duration_s": 0.01}), device=dev)
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


def _profiled(fn):
    """Run fn under torch.profiler; return (its wall without the profiler,
    its wall with it, CUDA kernel events as (name, device µs))."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    kernels = []
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            kernels.append((e.name, float(e.time_range.elapsed_us())))
    return wall, wall_prof, kernels


def phase_profile(dev, stats):
    """The cycle loop's launches per cycle and the device's busy share."""
    from repro_torch.api import build_bound, registry
    from repro_torch.core.archspec import (ForwardTableKind, SchedulerKind,
                                           SwitchArch, VOQKind)
    from repro_torch.sim import backannotate
    from repro_torch.sim.resources import synthesize
    from repro_torch.switch.switch import simulate

    bound = build_bound(registry["hft"])
    trace = registry["hft"].trace.build()
    runs = {
        # hft's first iSLIP calibration family, 1,456 cycles at saturation
        "calibration Full/NxN/ISLIP@128b d64": (
            SwitchArch(8, 128, ForwardTableKind.FULL_LOOKUP, VOQKind.NXN,
                       SchedulerKind.ISLIP, voq_depth=64, addr_bits=4), None),
        # the first 2,000 cycles of hft's rung-4 champion
        "rung4 Full/NxN/RR@128b d288": (
            SwitchArch(8, 128, ForwardTableKind.FULL_LOOKUP, VOQKind.NXN,
                       SchedulerKind.RR, voq_depth=288, addr_bits=4), 2000),
    }
    for what, (arch, cycles) in runs.items():
        fclk = synthesize(arch, bound).fmax_mhz * 1e6
        if cycles is None:
            def fn():
                backannotate._ETA_CACHE.clear()
                backannotate._measured_eta(arch, bound, fclk, device=dev)
            cycles = 1456
        else:
            def fn():
                simulate(arch, bound, trace, fclk_hz=fclk, max_cycles=cycles,
                         device=dev)
        wall, wall_prof, kernels = _profiled(fn)
        busy_us = sum(us for _, us in kernels)
        by_name = {}
        for name, us in kernels:
            n, t = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, t + us)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        rec = {"run": what, "cycles": cycles, "wall_s": wall,
               "us_per_cycle": wall * 1e6 / cycles,
               "wall_profiled_s": wall_prof,
               "kernels_per_cycle": len(kernels) / cycles,
               "device_us_per_cycle": busy_us / cycles,
               "device_busy_share": busy_us * 1e-6 / wall,
               "top_kernels_us": {name[:60]: [n, round(t, 1)] for name, (n, t) in top}}
        stats.setdefault("profile", []).append(rec)
        say("profile", **rec)
        if not kernels:
            raise AssertionError("torch.profiler recorded no CUDA kernel")


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

KERNELS = {
    "xbar_scan": {"source": "src/repro_torch/csrc/xbar.cu",
                  "replaces": "src/repro/kernels/xbar/kernel.py:54",
                  "main": ("xbar_abs_f64", "hft")},
    "netsim_replay": {"source": "src/repro_torch/csrc/netsim.cu",
                      "replaces": "src/repro/kernels/netsim/kernel.py:62",
                      "main": ("netsim_ungated_abs_f64", "hft")},
    # the cycle loop's call: one 8-port switch, the hft calibration's 2 rounds
    "islip_schedule": {"source": "src/repro_torch/csrc/islip.cu",
                       "replaces": "src/repro/kernels/islip/kernel.py:73",
                       "main": ("islip_n8_it2", "B1")},
    # hft's calibration trace: 9,600 headers parsed once before the loop
    "parse_headers": {"source": "src/repro_torch/csrc/parser.cu",
                      "replaces": "src/repro/kernels/parser/kernel.py:45",
                      "main": ("parser_hft", "B9600")},
}


def kernels_line(stats):
    """One entry per kernel: its main-path form and shape, the largest
    disagreement over every form and shape, and its path's launches."""
    out = []
    for name, meta in KERNELS.items():
        forms = [r for r in stats["forms"] if r["kernel"] == name]
        form, shape = meta["main"]
        main = next((r for r in forms if r["form"] == form
                     and r["shape"] == shape), {})
        out.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": stats["launches"].get(name, 0),
            "max_abs_err": max((r["max_abs_err"] for r in forms), default=None),
            "ms": main.get("ms"), "plain_ms": main.get("plain_ms"),
            "bound_ms": main.get("bound_ms"), "bound_by": main.get("bound_by"),
            "library_ms": None,
        })
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + OPTIONAL_PHASES}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + OPTIONAL_PHASES)
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

    stats = {"forms": [], "scale": [], "switch": [], "launches": {}}
    failed = []
    for name, fn in (("kernels", phase_kernels), ("path", phase_path),
                     ("scale", phase_scale), ("profile", phase_profile)):
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
