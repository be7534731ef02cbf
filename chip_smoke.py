#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases kernels   # a subset (device and build always run)

Phases, one result line each (every record also goes to
``build/chip_smoke_stats.json``); any failure exits non-zero without the
final ``{"ok": true, ...}`` line:

  device   the card's name and power limit (nvidia-smi).
  build    compile the hand-written kernels (one nvcc per source, together).
  kernels  each kernel in each form (xbar absolute float64 and slack
           float32; netsim ungated and gated absolute float64, gated slack
           float32, at hft's, datacenter's and evaluate_space's shapes and
           at 40 and 300 ports, each with its chain bound: the timeline's
           dependency depth times one step's latency, measured; iSLIP at 8
           and 32 ports, 1-4 iterations, batches of 1 and 4096; the header
           parser on the hft, datacenter and Ethernet/IPv4/UDP protocols
           at 9,600 and 1,048,576 headers (a wrapper call and the kernel
           alone); the fused cycle loop
           (switch_loop, every output) on hft's rung-4 champion at full
           length, the 12 forward table x VOQ x scheduler kinds on 2,000
           cycles of hft, 32-port iSLIP with 1-4 rounds on saturating
           traffic, a ring and a table placed in device memory, a
           Shared-VOQ incast that drops, a broadcast-heavy Ethernet
           header on a small hash table and a header whose keys lie past
           word 0, one across two words; int8 quantize from float32 and
           bfloat16 and dequantize to both, at the dispatch buffers of
           comm_small and moe_dispatch and of one full-width
           qwen3-moe-235b-a22b layer, [131072, 4096], with all-zero groups
           and exact .5 ties) against its plain PyTorch version on the card,
           bitwise (torch.equal), at the paths' shapes; the attention
           kernel in float32 (atol = rtol = 3e-5) and bfloat16 at
           llama3.2-1b's prefill (atol 1e-3, rtol 2**-7 against the plain
           version in bfloat16 at the kernel's tiles, a mask one key off
           outside that bar; within 2e-2 of the plain version in float32),
           with a sliding window, and PyTorch's SDPA timed beside the
           causal ones; bfloat16 D 64 and 128 must take the wgmma path;
           the bfloat16 bar over seeds 0-31 at the D 128 and llama forms,
           every pair inside it; the SSD kernel at mamba2-780m's prefill
           and a ragged length (atol = rtol = 2e-3; y and the final state);
           ms per call for both, and the bound; the ring-scan stage-4
           kernel (end and admit bitwise) at hft's and datacenter's shapes,
           64 ports (the k=8 fat-tree's edge tier flattened) and 300, at
           depths 1, 2, 8, 64 and 1,024 and a mixed batch, and on a
           SHARED-VOQ incast that drops, each with ms per call and kernel
           alone, ptxas registers and spills, its chain bound (m steps at
           the measured step latency) and its bytes bound.  "Kernel alone"
           (``kernel_ms``) is ``launch_ms``: CUDA events around replays of
           a CUDA graph of one call, for xbar, netsim, the parser, switch_loop (with
           its chain bound: its cycles times the least dependent step one
           cycle hands the next, measured) and the ring scan.
  path     six main paths, each with every kernel's launch counter set to 0
           just before and read just after:
           (a) run_scenario on the card for hft, datacenter, hft_nsga2,
           hft_codesign and fattree_dc with the settings their golden
           reports record (tests/golden/*.json), compared with those
           reports under the golden harness's rules (restated below), then
           the four single-switch goldens again with use_kernel="off" (the
           ring-scan engine; the scenario's fidelity.use_kernel the only
           field allowed to differ); xbar and netsim must launch (on
           fattree_dc too), and on the off runs ring_scan must launch and
           netsim_replay must not;
           (b) run_scenario for hft and datacenter (its trace cut to
           200 µs) at the registry's defaults (back-annotation on: the
           cycle-level switch calibrates the scheduler efficiency) with
           verify_engine="auto" (the champion escalated to the cycle-level
           switch), compared with the
           JAX package's runs recorded in tests/torch_golden/: the report,
           the escalated cycle result exactly, and the calibrated η;
           switch_loop (one launch per simulation, parsing each header at
           ingress) must launch, the batch parser must not.
           Stage walls, calibration and rung-4 walls, µs per cycle;
           (c) the comm domain: run_scenario on comm_small (against
           tests/golden/comm_small.json), moe_dispatch and grad_bucket
           (registry settings) with the JAX package's router, LSH projection
           and routing sample carried across from tests/torch_golden/,
           against the reference's runs stored there (report, each verified
           candidate's expert loads and drop rate); comm_small's layer
           output against the reference's within a stated tolerance and
           identical from run to run; quantize and dequantize must launch;
           (d) the model serving path at full width, on the port's seeded
           init: llama3.2-1b (16 layers) and mamba2-780m (48 layers)
           prefill of 4 x 8,192 tokens, twice each (the reference's
           prefill_32k cut from 32 x 32,768), with flash_attention launched
           16 times, all on its wgmma path, and ssd_scan 48 times per
           prefill (wall, tokens/s, the
           kernels' share from CUDA events around each launch, peak
           memory); ServeEngine on llama3.2-1b serving 8 requests (4 slots,
           max_new 16, s_max 256); and both models' prefill (2 layers, 1 x
           1,024 tokens, weights from the NumPy seed) against the JAX
           package's logits in tests/torch_golden/model_{llama,mamba}.
           (e) the DSE service (DSEServeEngine, 4 slots, stage-2 chunks of
           64 rows, stage-4 chunks of 16): the five goldens as recorded,
           twice, and hft with trace seed 1, interleaved; every report equal
           to its golden (the seeded one to run_scenario), the repeats
           report-cache hits, no request error; every stage-2 engine call
           at 64 rows and every stage-4 round-1 call at most 16 (a chunk's
           distinct rows), read from the engines' call keys; a second wave on a
           fresh engine adds no call key (retrace_guard(expect=0)); xbar
           and netsim must launch in the first wave; requests/s, stage-2
           candidates/s, wall per unique request;
           (f) hft_nsga2 stopped after 2 generations into a temporary
           checkpoint directory and resumed: the report equal to the golden
           and to the uninterrupted run, xbar and netsim launched by the
           stopped and the resumed run; then check over the registry, every
           scenario clean.
  scale    run_dse on a 40 ms hft capture (~372k events) and evaluate_space
           on a 10 ms one (~93k events, 480 candidate rows), with two
           candidates of each held bitwise against the serial run_surrogate /
           run_netsim; per-stage wall time, kernel ms, peak device memory;
           the same run_dse under both stage-4 engines in the order auto,
           off, off, auto, the timeline memo cleared before each run, every
           stage-4 result equal to the first auto run's (ring_scan ms, stage
           walls by engine); a k=8 fat-tree (32 hosts, fattree_dc's scenario
           on a 10 ms datacenter trace) in the same order, the reports equal
           apart from *_time_s;
           and autotune_moe on one full-width qwen3-moe-235b-a22b MoE layer
           (d_model 4096, expert d_ff 1536, 128 experts, top-8; 8 x 1,024
           tokens; the port's seeded init, model_tp 16): stage walls, kernel
           ms and launches, peak memory, the int8 payload's relative error
           against bf16, and the invariants (loads sum to tokens x k, the
           champion's drop rate within the SLA).
  profile  (only when named) the cycle-level switch under
           torch.profiler: kernel launches per simulated cycle, the device's
           busy share, and device time by kernel, for hft's iSLIP
           calibration run and 2,000 cycles of its rung-4 champion (the
           fused loop: one switch_loop launch per simulation); then
           cProfile over one datacenter calibration (32 ports): the host
           functions that take its wall.

Needs no network and imports nothing of JAX or of the JAX package ``repro``.
Exits non-zero when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import dataclasses
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
GOLDEN = ("hft", "datacenter", "hft_nsga2", "hft_codesign", "fattree_dc")
#: the goldens run a second time with the ring-scan engine (use_kernel
#: "off"), against the same reports: the scenario's fidelity.use_kernel is
#: the only field allowed to differ
GOLDEN_OFF = ("hft", "datacenter", "hft_nsga2", "hft_codesign")
#: the cycle-level switch's runs, tests/torch_golden/<name>.{json,npz}:
#: (registry entry, trace overrides); datacenter's trace is cut from 800 to
#: 200 µs (149,546 -> 24,203 rung-4 cycles) to keep this script well inside
#: its time limit
SWITCH_RUNS = {"hft_auto": ("hft", None),
               "datacenter_auto": ("datacenter", {"duration_s": 2e-4})}
SIM_ARRAYS = ("latency_cycles", "latency_ns", "occ_max", "occ_trace")
#: the comm runs, tests/torch_golden/<name>.{json,npz} (the JAX package's
#: runs at these settings, with their inputs)
COMM_RUNS = ("comm_small", "moe_dispatch", "grad_bucket")
#: comm_small's layer output against the reference's, relative to max |y|
#: (the expert FFN's bfloat16 products round differently in cuBLAS and XLA)
Y_RTOL = 2e-2
#: a header built with the DSL whose routing and src keys lie past word 0,
#: the routing key across words 1 and 2 (bits 54-65), so that the switch
#: loop's ingress parse runs its two-piece path: (name, bits, semantic)
MULTIWORD_FIELDS = (("flow", 54, None), ("dst", 12, "routing_key"),
                    ("src", 12, "src_key"), ("len", 14, "length"))
#: the full-width MoE layer of the scale phase
SCALE_ARCH = "qwen3-moe-235b-a22b"
SCALE_TOKENS = (8, 1024)

#: H100 SXM peaks used for bounds: HBM bandwidth, non-tensor FP64/FP32 and
#: dense bf16 tensor-core work (NVIDIA's data sheet, at the 700 W power
#: limit), keyed by the operands' bytes per element; 32-bit integer work is
#: bounded by the float32 rate, which no integer pipe exceeds, and float32
#: attention/SSD work by it too (TF32 would not keep float32's digits)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {8: 34e12, 4: 67e12, 2: 989e12}

#: the serving path (d): full-width prefills of B x S tokens, the reference's
#: prefill_32k shape (configs/shapes.py: 32 x 32,768) cut to 4 x 8,192
SERVE_PREFILL = {"llama3.2-1b": 16, "mamba2-780m": 48}   # arch -> layers (all)
PREFILL_BS = (4, 8192)
#: ServeEngine at the launcher's defaults on llama3.2-1b at full width
SERVE_ENGINE = dict(requests=8, slots=4, max_new=16, s_max=256)
#: tests/torch_golden/model_{llama,mamba}: the reference's last-token prefill
#: logits at full width, 2 layers, B 1, S 1,024, attn_impl="blockwise"
MODEL_FIXTURES = {"model_llama": "llama3.2-1b", "model_mamba": "mamba2-780m"}


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

#: xbar and netsim shapes of the kernels phase, name -> (B, m, n_ports):
#: hft's stage 2 and 4 (48 candidates, 3,707 events, 8 ports), datacenter's
#: (530 events, 32 ports), evaluate_space's 480 rows, and two off the path:
#: 40 ports (two register slots a lane) and 300 (slots in shared memory),
#: each at a length no 32 divides and a B no block's 4 rows divide
SCAN_SHAPES = {"hft": (48, 3707, 8), "datacenter": (8, 530, 32),
               "space480": (480, 3707, 8), "ports40": (7, 1001, 40),
               "ports300": (5, 777, 300)}
#: dependent steps of the one-thread kernel that times one scan step
CHAIN_STEPS = 1 << 20


def scan_slots(n_ports: int) -> int:
    """Register slots a lane holds at ``n_ports`` (0: shared memory), as
    ``csrc/port_scan.cuh`` scan_slots picks them."""
    s = -(-n_ports // 32)
    return next((c for c in (1, 2, 4, 8) if s <= c), 0)


#: the mangled-name pieces of each scan form's instantiation, for its ptxas
#: record: port_scan_levels<Step, T, GATED> for the absolute forms,
#: port_scan<Step, T, GATED, SLOTS> (slots appended) for the slack forms
#: (the kernel's name too: port_chain<Step, T, DEP> mangles alike)
SCAN_PTXAS = {"xbar_abs_f64": ("xbar", "16port_scan_levelsI", "XbarAbsEdLb0EE"),
              "xbar_slack_f32": ("xbar", "9port_scanI", "XbarSlackEfLb0ELi{}E"),
              "netsim_ungated_abs_f64": ("netsim", "16port_scan_levelsI",
                                         "NetsimAbsEdLb0EE"),
              "netsim_gated_abs_f64": ("netsim", "16port_scan_levelsI", "NetsimAbsEdLb1EE"),
              "netsim_gated_slack_f32": ("netsim", "9port_scanI",
                                         "NetsimSlackEfLb1ELi{}E")}


def scan_schedule(form: str, n_ports: int) -> str:
    """How ``csrc/port_scan.cuh`` runs a form: the absolute forms by levels
    of 32-event groups, the slack forms one event a step with the port
    state in register slots (0: shared memory)."""
    return "levels" if form.endswith("f64") else f"serial, {scan_slots(n_ports)} slots"


def scan_ptxas(form: str, n_ports: int):
    """``ptxas -v``'s registers and spills for the instantiation of
    ``form`` that ``n_ports`` takes."""
    from repro_torch.kernels.build import _target
    lib, kernel, step = SCAN_PTXAS[form]
    log = _target(lib).with_suffix(".log")
    return (_ptxas_entry(log.read_text(), (kernel, step.format(scan_slots(n_ports))))
            if log.exists() else None)


def chain_step_ns(dev, family: str, absolute: bool, decay_only: bool = False) -> float:
    """ns of one dependent step of a scan form (two maxima and one add;
    the slack forms also decay; ``decay_only``: the slack forms' decay
    alone), from CHAIN_STEPS of them on one thread, timed with CUDA
    events."""
    import torch
    from repro_torch.kernels.netsim import kernel as nk
    from repro_torch.kernels.xbar import kernel as xk
    step = (xk if family == "xbar" else nk).chain_step
    dtype = torch.float64 if absolute else torch.float32
    io = torch.tensor([0.0, 1e-8, 1e-8, 2e-8, 3e-8], dtype=dtype, device=dev)
    step(io, 1024, absolute=absolute, decay_only=decay_only)      # warm up
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    step(io, CHAIN_STEPS, absolute=absolute, decay_only=decay_only)
    e1.record()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(io).all()), io
    return e0.elapsed_time(e1) * 1e6 / CHAIN_STEPS


def switch_chain_step_ns(dev) -> float:
    """ns of the least dependent step one cycle of ``switch_loop`` hands the
    next (a ballot of the busy outputs, a shuffle of the hold, a maximum),
    from CHAIN_STEPS of them on one warp, timed with CUDA events."""
    import torch
    from repro_torch.kernels.switch_loop import kernel as slk
    io = torch.arange(32, dtype=torch.int32, device=dev) % 5
    slk.chain_step(io, 1024)                                   # warm up
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    slk.chain_step(io, CHAIN_STEPS)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) * 1e6 / CHAIN_STEPS


def phase_kernels(dev, stats):
    """Each kernel form against its plain version, bitwise, at path shapes."""
    import numpy as np
    import torch
    from repro_torch.kernels.chain import chain_depth
    from repro_torch.kernels.netsim import kernel as nk
    from repro_torch.kernels.netsim import ref as nref
    from repro_torch.kernels.xbar import kernel as xk
    from repro_torch.kernels.xbar import ref as xref

    t_step = {(fam, absolute): chain_step_ns(dev, fam, absolute)
              for fam in ("xbar", "netsim") for absolute in (True, False)}
    t_decay = {fam: chain_step_ns(dev, fam, False, decay_only=True)
               for fam in ("xbar", "netsim")}
    ok = True
    for shape, (b, m, n) in SCAN_SHAPES.items():
        rng = np.random.default_rng(0)
        for f64 in (True, False):
            t, src, dst, svc, pipe, admit = timeline(rng, m, n, b, f64=f64)
            depth = {False: chain_depth(src, dst), True: chain_depth(src, dst, admit)}
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
                alone_ms = launch_ms(kern, reps=5)
                p_ms = wall_ms(plain)
                item = size = got.element_size()
                gated = "gated" in form and "ungated" not in form
                netsim = form.startswith("netsim")
                moved = (b * m * size * 2 + m * (size + 8)
                         + (b * size if netsim else 0) + (b * m if gated else 0))
                flops = b * m * (4 if netsim else 3)
                bound = max(moved / HBM_BYTES_PER_S,
                            flops / PEAK_FLOPS[item]) * 1e3
                # the dependent chain: L steps (each row's admitted events
                # in the gated forms) at the measured latency of one step;
                # in the slack forms also each port's m dependent decays
                fam = "netsim" if netsim else "xbar"
                step_ns = t_step[(fam, f64)]
                decay_ns = None if f64 else t_decay[fam]
                by_depth = depth[gated] * step_ns * 1e-6
                by_decays = 0.0 if f64 else m * decay_ns * 1e-6
                rec = {"kernel": "netsim_replay" if netsim else "xbar_scan",
                       "shape": shape, "B": b, "m": m, "n_ports": n,
                       "form": form, "bitwise_equal": equal,
                       "max_abs_err": err, "ms": k_ms, "kernel_ms": alone_ms,
                       "plain_ms": p_ms, "bound_ms": bound,
                       "bound_by": ("bytes" if moved / HBM_BYTES_PER_S
                                    >= flops / PEAK_FLOPS[item]
                                    else "operations"),
                       "depth_L": depth[gated], "t_step_ns": step_ns,
                       "decays": 0 if f64 else m, "t_decay_ns": decay_ns,
                       "chain_bound_ms": max(by_depth, by_decays),
                       "chain_bound_by": "depth" if by_depth >= by_decays else "decays",
                       "ns_per_event": alone_ms * 1e6 / m,
                       "schedule": scan_schedule(form, n),
                       "ptxas": scan_ptxas(form, n)}
                stats["forms"].append(rec)
                say("kernels", **rec)
                ok &= equal
    ok &= kernels_islip(dev, stats)
    ok &= kernels_parser(dev, stats)
    ok &= kernels_switch_loop(dev, stats)
    ok &= kernels_quant(dev, stats)
    ok &= kernels_flash(dev, stats)
    ok &= kernels_flash_cross(dev, stats)
    ok &= kernels_flash_seeds(dev, stats)
    ok &= kernels_ssd(dev, stats)
    ok &= kernels_ring_scan(dev, stats)
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


#: GPU clock cycles ``launch_ms`` keeps the stream busy for each replay it
#: queues (~30 µs), longer than the host takes to queue one replay
LAUNCH_LEAD_CYCLES = 60_000


def launch_ms(fn, reps: int) -> float:
    """Device time per call of the kernels ``fn`` launches, alone: one call
    of ``fn`` is captured into a CUDA graph, which holds exactly the device
    work the call queued (its launches and the fills of the buffers it
    zeroes, such as the ring scan's tail past 241 ports), without the
    wrapper's host checks and allocations, and the graph is replayed
    ``reps`` times between two CUDA events.  A spin kernel
    (``torch.cuda._sleep``) ahead of the start event keeps the stream busy
    while the host queues the replays, so the bracket holds the kernels and
    the gaps between them, not the host's launch latency.  The wrappers
    leave their port-id reads to the uncaptured warm-up call on the same
    inputs (``kernels/build.py``'s ``capturing``).  Replaces torch.profiler,
    which lost records of these short kernels."""
    import torch
    fn()                                   # warm up: builds, types and checks
    torch.cuda.synchronize()
    before = _read_counters()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        held = fn()          # its outputs stay allocated while the graph replays
    if _read_counters() == before:
        raise AssertionError("launch_ms: the call launched no counted kernel")
    graph.replay()                         # the first replay uploads the graph
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(LAUNCH_LEAD_CYCLES * reps)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del held, graph
    return e0.elapsed_time(e1) / reps


#: the header parser's forms: each protocol (``parser_protocol``) at 9,600
#: headers (hft's calibration trace) and 1,048,576
PARSER_PROTOCOLS = ("hft", "datacenter", "ethernet_ipv4_udp")
PARSER_BATCHES = (9600, 1048576)


def parser_protocol(name):
    """A parser form's protocol: a registry scenario's, or the stock
    Ethernet/IPv4/UDP stack (11 words, 17 fields in 20 pieces)."""
    from repro_torch.api import build_bound, registry
    from repro_torch.core import ethernet_ipv4_udp
    if name == "ethernet_ipv4_udp":
        return ethernet_ipv4_udp()
    return build_bound(registry[name]).protocol


def parser_words(proto, b: int, dev, seed: int = 1):
    """b headers of random field values, packed, on ``dev``."""
    import numpy as np
    import torch
    from repro_torch.switch.parser import pack_header_words
    rng = np.random.default_rng(seed)
    vals = {f.name: rng.integers(0, 2 ** min(f.bits, 63), b, dtype=np.uint64)
            for f in proto.fields}
    return torch.from_numpy(pack_header_words(proto, vals)).to(dev)


def kernels_parser(dev, stats):
    """The header parser on the hft, datacenter and Ethernet/IPv4/UDP
    protocols, every field: the switch's calibration trace (9,600
    headers) and a million headers.  ``ms`` is a wrapper call,
    ``kernel_ms`` the kernel alone (``launch_ms``)."""
    import torch
    from repro_torch.kernels.parser import parse_headers, parse_ref, slices
    from repro_torch.kernels.parser import kernel as pk

    ok = True
    for name in PARSER_PROTOCOLS:
        proto = parser_protocol(name)
        fields = [f.name for f in proto.fields]
        sl = slices(proto, fields)
        for b in PARSER_BATCHES:
            words = parser_words(proto, b, dev)
            w, f = words.shape[1], len(fields)
            kern = lambda: parse_headers(proto, fields, words)   # noqa: E731
            plain = lambda: parse_ref(proto, fields, words)      # noqa: E731
            n0 = pk.LAUNCHES
            got, want = kern(), plain()
            torch.cuda.synchronize()
            assert pk.LAUNCHES == n0 + 1, "parse_headers did not launch the kernel"
            pieces = sum(len(p) for p in sl.baked)
            bound, by = _bound(b * (w + f) * 4, b * pieces * 4, 4)
            k_ms = launch_ms(kern, reps=20)
            rows, smem = pk.plan(w, f, b, torch.cuda.get_device_properties(
                dev).multi_processor_count)
            rec = {"kernel": "parse_headers", "form": f"parser_{name}",
                   "shape": f"B{b}", "B": b, "words": w, "fields": f, "pieces": pieces,
                   "ms": cuda_ms(kern, reps=20), "kernel_ms": k_ms,
                   "plain_ms": wall_ms(plain), "bound_ms": bound, "bound_by": by,
                   "bound_share": bound / k_ms, "tile_rows": rows, "smem_bytes": smem}
            ok &= _record(stats, rec, (got,), (want,))
    return ok


def _switch_form(arch, bound, trace, fclk, max_cycles, dev):
    """The fused loop's inputs for one simulation, as simulate makes them:
    arr_pid, the header words, the sizes and the keys' baked slices."""
    import torch
    from repro_torch.kernels.parser import slices
    from repro_torch.switch.switch import prepare_cycle_inputs
    prep = prepare_cycle_inputs(arch, bound, trace, fclk, max_cycles=max_cycles)
    keys = slices(bound.protocol, [bound.semantics["routing_key"],
                                   bound.semantics["src_key"]]).baked
    return (torch.from_numpy(prep["arr_pid"]).to(dev),
            torch.from_numpy(prep["header_words"]).to(dev),
            torch.from_numpy(prep["size_flits"]).to(dev), keys)


def multiword_protocol():
    """``MULTIWORD_FIELDS`` as a protocol of the port's DSL."""
    from repro_torch.core.dsl import Field, Protocol
    return Protocol("multiword", [Field(n, b, semantic=sem)
                                  for n, b, sem in MULTIWORD_FIELDS])


def _port_trace(name, senders, n_ports, cycles, fclk, dst_of, payload):
    """One packet per cycle from each of ports 0..senders-1 (saturation),
    destinations dst_of(rng, src, count)."""
    import numpy as np
    from repro_torch.traces.base import Trace
    rng = np.random.default_rng(2)
    t = np.arange(cycles) / fclk
    times, srcs, dsts = [], [], []
    for s in range(senders):
        times.append(t)
        srcs.append(np.full(cycles, s))
        dsts.append(dst_of(rng, s, cycles))
    return Trace(name, np.concatenate(times), np.concatenate(srcs),
                 np.concatenate(dsts), np.full(senders * cycles, payload), n_ports)


def switch_loop_forms(dev):
    """form -> (arch, bound, trace, fclk, max_cycles) of the fused loop's
    checks: hft's rung-4 champion at full length (the main form, 97,720
    cycles); the 12 table x VOQ x scheduler kinds on a 2,000-cycle cut of
    hft; 32-port iSLIP on datacenter's calibration traffic with 1-4 rounds;
    a ring and a table too large for shared memory; a Shared-VOQ incast
    that drops; a broadcast-heavy Ethernet header on a small hash table
    (evictions, unlearned destinations); and a header whose keys lie past
    word 0, one across two words (``MULTIWORD_FIELDS``)."""
    import numpy as np
    from repro_torch.api import build_bound, registry
    from repro_torch.core import bind, ethernet_ipv4_udp
    from repro_torch.core.archspec import (ForwardTableKind, SchedulerKind,
                                           SwitchArch, VOQKind)
    from repro_torch.sim.resources import synthesize

    def fclk(arch, bound):
        return synthesize(arch, bound).fmax_mhz * 1e6

    hft_bound = build_bound(registry["hft"])
    hft_trace = registry["hft"].trace.build()
    forms = {}
    champ = SwitchArch(8, 128, ForwardTableKind.FULL_LOOKUP, VOQKind.NXN,
                       SchedulerKind.RR, voq_depth=288, addr_bits=4)
    forms["hft_rung4_champion"] = (champ, hft_bound, hft_trace,
                                   fclk(champ, hft_bound), None)
    for fwd in ForwardTableKind:
        for voq in VOQKind:
            for sched in SchedulerKind:
                arch = SwitchArch(8, 128, fwd, voq, sched, voq_depth=2, addr_bits=4,
                                  hash_banks=2, hash_depth=8)
                name = f"hft2000_{fwd.value}_{voq.value}_{sched.value}"
                forms[name] = (arch, hft_bound, hft_trace, fclk(arch, hft_bound), 2000)
    dc_bound = build_bound(registry["datacenter"])
    for iters in (1, 2, 3, 4):
        arch = SwitchArch(32, 1024, ForwardTableKind.FULL_LOOKUP, VOQKind.NXN,
                          SchedulerKind.ISLIP, voq_depth=36, islip_iters=iters,
                          addr_bits=5)
        f = fclk(arch, dc_bound)
        uniform = _port_trace("calib32", 32, 32, 1200, f, lambda rng, s, c: (
            (lambda d: np.where(d >= s, d + 1, d))(rng.integers(0, 31, c))), 64)
        forms[f"islip32_it{iters}"] = (arch, dc_bound, uniform, f, 1456)
    # state that does not fit in shared memory (kernel.plan): a 32-port
    # depth-2,048 ring, and a 16-bit full-lookup table, in device memory
    arch = SwitchArch(32, 256, ForwardTableKind.MULTIBANK_HASH, VOQKind.SHARED,
                      SchedulerKind.EDRRM, voq_depth=2048, addr_bits=5)
    f = fclk(arch, dc_bound)
    forms["ring_in_device_memory"] = (arch, dc_bound, _port_trace(
        "calib32", 32, 32, 1200, f, lambda rng, s, c: rng.integers(0, 32, c), 16),
        f, 1456)
    arch = SwitchArch(8, 128, ForwardTableKind.FULL_LOOKUP, VOQKind.NXN,
                      SchedulerKind.ISLIP, voq_depth=64, addr_bits=16)
    forms["table_in_device_memory"] = (arch, hft_bound, hft_trace,
                                       fclk(arch, hft_bound), 2000)
    arch = SwitchArch(8, 128, ForwardTableKind.FULL_LOOKUP, VOQKind.SHARED,
                      SchedulerKind.ISLIP, voq_depth=4, addr_bits=4)
    f = fclk(arch, hft_bound)
    incast = _port_trace("incast", 8, 8, 600, f, lambda rng, s, c: np.full(c, 0 if s else 1), 16)
    forms["shared_incast"] = (arch, hft_bound, incast, f, 1000)
    eth = bind(ethernet_ipv4_udp(), flit_bits=256)
    arch = SwitchArch(8, 128, ForwardTableKind.MULTIBANK_HASH, VOQKind.SHARED,
                      SchedulerKind.EDRRM, voq_depth=8, addr_bits=48, hash_banks=2,
                      hash_depth=4)
    f = fclk(arch, eth)
    # ports 0-3 send, to all 8: ports 4-7 are never learned (broadcast)
    bcast = _port_trace("bcast", 4, 8, 500, f, lambda rng, s, c: rng.integers(0, 8, c), 16)
    forms["eth_hash_broadcast"] = (arch, eth, bcast, f, 1500)
    # keys past word 0, the routing key across two words, on hft's traffic
    multi = bind(multiword_protocol(), flit_bits=256)
    arch = SwitchArch(8, 128, ForwardTableKind.FULL_LOOKUP, VOQKind.NXN,
                      SchedulerKind.ISLIP, voq_depth=8, addr_bits=4)
    forms["multiword_keys"] = (arch, multi, hft_trace, fclk(arch, multi), 2000)
    return forms


def kernels_switch_loop(dev, stats):
    """The fused cycle loop against the eager loop, bitwise, every output."""
    import torch
    from repro_torch.kernels.switch_loop import kernel as slk
    from repro_torch.kernels.switch_loop import switch_loop_ref

    cycle_ns = switch_chain_step_ns(dev)
    ok = True
    for form, (arch, bound, trace, fclk, cycles) in switch_loop_forms(dev).items():
        arr, words, sizes, keys = _switch_form(arch, bound, trace, fclk, cycles, dev)
        kern = lambda: slk.switch_loop_launch(arch, arr, words, sizes, keys)  # noqa: E731
        plain = lambda: switch_loop_ref(arch, arr, words, sizes, keys)       # noqa: E731
        got = kern()
        torch.cuda.synchronize()
        t_plain = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t_plain) * 1e3
        t, n = arr.shape
        npkt = words.shape[0]
        key_words = len({p[0] for pieces in keys for p in pieces})
        # read arr_pid, the header words holding each packet's keys and its
        # size once; write its departure cycle, the occupancy trace, the
        # per-queue maxima and 3 counters
        moved = (t * n * 4 + npkt * (4 * key_words + 4) + max(npkt, 1) * 8 + t * 8
                 + n * n * 8 + 24)
        bound_ms, by = _bound(moved, t * n * n, 4)
        k_ms = cuda_ms(kern, reps=3)
        alone_ms = launch_ms(kern, reps=3)
        p = slk.plan(arch, npkt)
        rec = {"kernel": "switch_loop", "form": form, "shape": f"T{t}",
               "arch": arch.short(), "n_ports": n, "packets": npkt, "cycles": t,
               "delivered": int(want.delivered), "drops": int(want.drops),
               "ms": k_ms, "kernel_ms": alone_ms, "plain_ms": p_ms,
               "bound_ms": bound_ms, "bound_by": by,
               "header_words": words.shape[1], "key_words": key_words,
               "chain_cycles": t, "t_cycle_step_ns": cycle_ns,
               "chain_bound_ms": t * cycle_ns * 1e-6,
               "chain_bound_by": "cycles x the least dependent step",
               "us_per_cycle": k_ms * 1e3 / max(t, 1),
               "kernel_us_per_cycle": alone_ms * 1e3 / max(t, 1),
               "plain_us_per_cycle": p_ms * 1e3 / max(t, 1),
               "smem_bytes": p.smem_bytes, "table_shared": p.table_shared,
               "ring_shared": p.ring_shared}
        ok &= _record(stats, rec, tuple(got), tuple(want))
        if int(want.delivered) == 0:
            print(f"switch_loop form {form} delivered nothing", file=sys.stderr)
            ok = False
    return ok


def dispatch_rows(tokens: int, k: int, experts: int, cf: float,
                  chunks: int = 1) -> int:
    """Rows of one chunk of the fabric's dispatch buffer [E * c_sub, d]."""
    cap = max(int(math.ceil(tokens * k / experts * cf)), 1)
    n = max(1, min(chunks, cap))
    return experts * -(-cap // n)


#: the buffers the int8 payload quantizes: (rows, d_model) per chunk
QUANT_SHAPES = {
    # comm_small's champion cf=2.00/int8/a2a×1: 128 tokens, top-2 of 8
    "comm_small": (dispatch_rows(128, 2, 8, 2.0), 128),
    # moe_dispatch's champion cf=1.50/int8/a2a×2: 2,048 tokens, top-4 of 32
    "moe_dispatch": (dispatch_rows(2048, 4, 32, 1.5, 2), 512),
    # one full-width qwen3-moe-235b-a22b layer at cf 2.0: 8,192 tokens,
    # top-8 of 128, cap 1,024
    "qwen3_full": (dispatch_rows(8192, 8, 128, 2.0), 4096),
}


def quant_inputs(r: int, c: int, dev, seed: int):
    """[r, c] float32 with row scales from 0.01 to 100, all-zero groups and
    a group of exact .5 ties (absmax 127 -> scale 1.0)."""
    import torch
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((r, c), generator=g, device=dev)
    lo, hi = math.log(0.01), math.log(100.0)
    x *= torch.exp(torch.rand((r, 1), generator=g, device=dev) * (hi - lo) + lo)
    x[::7, :128] = 0.0
    ties = torch.randint(-126, 126, (128,), generator=g, device=dev) + 0.5
    ties[0] = 127.0
    x[1 % r, :128] = ties
    return x


def kernels_quant(dev, stats):
    """int8 quantize (float32 and bfloat16 in) and dequantize (float32 and
    bfloat16 out) at the comm paths' dispatch buffers."""
    import torch
    from repro_torch.kernels.quant_pack import kernel as qk
    from repro_torch.kernels.quant_pack.ref import dequantize_ref, quantize_ref

    ok = True
    for i, (shape, (r, c)) in enumerate(QUANT_SHAPES.items()):
        x32 = quant_inputs(r, c, dev, seed=i)
        for name, x in (("f32", x32), ("bf16", x32.to(torch.bfloat16))):
            kern = lambda: qk.quantize(x)                       # noqa: E731
            plain = lambda: quantize_ref(x)                     # noqa: E731
            got, want = kern(), plain()
            torch.cuda.synchronize()
            # read x once, write the codes and one scale per group; per
            # element |x|, a max, a division, a rounding and two clamps
            moved = r * c * (x.element_size() + 1) + r * c // 128 * 4
            bound, by = _bound(moved, 6 * r * c, 4)
            rec = {"kernel": "quantize", "form": f"quantize_{name}",
                   "shape": shape, "R": r, "C": c,
                   "ms": cuda_ms(kern, reps=20), "plain_ms": wall_ms(plain),
                   "bound_ms": bound, "bound_by": by}
            ok &= _record(stats, rec, got, want)
            del got, want
        q, s = qk.quantize(x32.to(torch.bfloat16))
        del x32
        for name, out in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            kern = lambda: qk.dequantize(q, s, out)             # noqa: E731
            plain = lambda: dequantize_ref(q, s, out)           # noqa: E731
            got, want = kern(), plain()
            torch.cuda.synchronize()
            item = torch.empty((), dtype=out).element_size()
            moved = r * c * (1 + item) + r * c // 128 * 4
            bound, by = _bound(moved, 2 * r * c, 4)
            rec = {"kernel": "dequantize", "form": f"dequantize_{name}",
                   "shape": shape, "R": r, "C": c,
                   "ms": cuda_ms(kern, reps=20), "plain_ms": wall_ms(plain),
                   "bound_ms": bound, "bound_by": by}
            ok &= _record(stats, rec, (got,), (want,))
            del got, want
        del q, s
        torch.cuda.empty_cache()
    return ok


def _attn_inputs(b, hq, hkv, s, d, dev, dtype, seed):
    import torch
    g = torch.Generator(dev).manual_seed(seed)
    q = torch.randn((b, hq, s, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=g, device=dev).to(dtype)
    return q, k, v


def _attn_work(b, hq, hkv, s, d, window, item):
    """(bytes moved, FLOP) of causal attention: q, k, v read once, o
    written once; 4·D FLOP per visible (query, key) pair."""
    w = window or s
    pairs = sum(min(i + 1, w) for i in range(s)) if window else s * (s + 1) // 2
    return (2 * b * hq * s * d + 2 * b * hkv * s * d) * item, 4 * b * hq * d * pairs


#: (form, shape name, B, Hq, Hkv, S, D, window, dtype): float32 at the
#: reference's kernel-test shape, bfloat16 at llama3.2-1b's prefill, a
#: window at hymba-1.5b's heads and sliding window, and the other head dims
#: of the zoo (128: the large dense/MoE/VLM archs; 32: the smoke configs,
#: which take the FMA path in bfloat16 too)
FLASH_FORMS = (("f32_causal", "gqa_small", 2, 8, 2, 256, 64, 0, "f32"),
               ("f32_window", "gqa_window", 2, 8, 2, 2048, 64, 1024, "f32"),
               ("bf16_causal", "llama_prefill", 4, 32, 8, 8192, 64, 0, "bf16"),
               ("bf16_window", "hymba_window", 1, 25, 5, 4096, 64, 1024, "bf16"),
               ("bf16_d128", "gqa_d128", 2, 16, 4, 1024, 128, 0, "bf16"),
               ("bf16_d32", "gqa_d32", 2, 4, 2, 1000, 32, 0, "bf16"))


#: bfloat16 bar of the attention kernel against its plain version run in
#: bfloat16 at the kernel's key tiles (the same P rounding): outputs agree
#: to within an output ulp (rtol 2**-7) plus FLASH_BF16_ATOL, 17x under the
#: typical |o| of a late row at S 8,192 (~0.017)
FLASH_BF16_ATOL = 1e-3
#: keys per tile of the bfloat16 wgmma path (kernels/flash_attention/kernel.py
#: KEY_TILE; tests/test_torch_attention.py holds the two equal); the FMA
#: path's tile is the wrapper's plan()
FLASH_TILE = 128


def kernels_flash(dev, stats):
    """The attention kernel against its plain version: float32 at
    atol = rtol = 3e-5 (tests/test_kernels.py's bar); bfloat16 against the
    plain version run in bfloat16 at the kernel's tiles at atol =
    FLASH_BF16_ATOL, rtol = 2**-7, and within 2e-2 of it run in float32.
    Each bfloat16 form also shows that its bar sees a mask one key off: the
    plain version with the causal edge (and window) moved by one key falls
    outside it on the rows of the sequence's second half.  bfloat16 D 64 and
    128 must take the wgmma path (its launch counter), with the shared
    memory the wrapper's plan() states.  SDPA is timed on every causal form
    without a window."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import blockwise_ref

    assert fk.KEY_TILE == FLASH_TILE, (fk.KEY_TILE, FLASH_TILE)
    ok = True
    for form, shape, b, hq, hkv, s, d, window, dt in FLASH_FORMS:
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        q, k, v = _attn_inputs(b, hq, hkv, s, d, dev, dtype, seed=s + hq)
        kern = lambda: fk.flash_attention(q, k, v, causal=True, window=window)  # noqa: E731
        plain = lambda: blockwise_ref(q, k, v, causal=True, window=window)     # noqa: E731
        plan = fk.plan(dtype, d, s)
        n0, w0 = fk.LAUNCHES, fk.LAUNCHES_WGMMA
        got = kern()
        torch.cuda.synchronize()
        assert fk.LAUNCHES == n0 + 1, "flash_attention did not launch the kernel"
        wgmma = dt == "bf16" and d in (64, 128)
        assert plan["path"] == ("wgmma" if wgmma else "fma"), (form, plan)
        assert fk.LAUNCHES_WGMMA == w0 + wgmma, f"{form} did not take the wgmma path"
        if wgmma:
            assert fk.wgmma_smem(d) == plan["smem"], (form, fk.wgmma_smem(d), plan)
        rec = {"kernel": "flash_attention", "form": form, "shape": shape, "B": b,
               "Hq": hq, "Hkv": hkv, "S": s, "D": d, "window": window,
               "path": plan["path"], "key_tile": plan["key_tile"],
               "fma_rows": plan.get("fma_rows", s)}
        if dt == "f32":
            want = plain()
            err = float((got - want).abs().max())
            good = bool(torch.allclose(got, want, atol=3e-5, rtol=3e-5))
        else:
            want = blockwise_ref(q, k, v, causal=True, window=window,
                                 block_k=plan["key_tile"])
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            # the largest share of the bar taken; allclose passes at <= 1
            rec["bar_share"] = float((diff / (FLASH_BF16_ATOL
                                              + 2 ** -7 * want.float().abs())).max())
            good = rec["bar_share"] <= 1.0
            del diff
            f32 = blockwise_ref(q.float(), k.float(), v.float(), causal=True,
                                window=window)
            rec["max_abs_err_vs_f32"] = float((got.float() - f32).abs().max())
            good &= rec["max_abs_err_vs_f32"] <= 2e-2
            del f32
            # the bar against a mask one key off, on rows S/2.. (row r sees
            # keys r - window .. r - 1 instead of r - window + 1 .. r)
            off = blockwise_ref(q[:, :, 1:], k[:, :, :-1], v[:, :, :-1], causal=True,
                                window=window, block_k=plan["key_tile"])[:, :, s // 2:]
            late = got[:, :, 1 + s // 2:].float()
            rec["one_key_off_caught"] = not bool(torch.allclose(
                late, off.float(), atol=FLASH_BF16_ATOL, rtol=2 ** -7))
            good &= rec["one_key_off_caught"]
            del off, late
        del want
        moved, flops = _attn_work(b, hq, hkv, s, d, window, got.element_size())
        bound, by = _bound(moved, flops, got.element_size())
        rec.update({"max_abs_err": err, "within_tolerance": good,
                    "ms": cuda_ms(kern, reps=5), "plain_ms": wall_ms(plain),
                    "bound_ms": bound, "bound_by": by, "library_ms": None})
        rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
        if dt == "bf16" and not window:
            rec["library_ms"] = cuda_ms(lambda: _sdpa(F, q, k, v), reps=5)
        stats["forms"].append(rec)
        say("kernels", **rec)
        ok &= good
        del q, k, v, got
    return ok


#: bfloat16 calls with more keys than queries (row i sees keys up to
#: i + T - S) and more query rows than the FMA head takes, so that the wgmma
#: kernel runs from row fma_rows on with that offset: (B, Hq, Hkv, S, T, D)
FLASH_CROSS_FORMS = ((2, 8, 2, 300, 500, 64), (2, 8, 2, 300, 500, 128))


def kernels_flash_cross(dev, stats):
    """The bfloat16 kernel at T > S against its plain version at its key
    tiles, at kernels_flash's bar, and within 2e-2 of it run in float32;
    each call must launch the wgmma kernel."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import blockwise_ref

    ok = True
    for b, hq, hkv, s, t, d in FLASH_CROSS_FORMS:
        g = torch.Generator(dev).manual_seed(s + t + d)
        q = torch.randn((b, hq, s, d), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((b, hkv, t, d), generator=g, device=dev).bfloat16()
                for _ in range(2))
        plan = fk.plan(torch.bfloat16, d, s)
        w0 = fk.LAUNCHES_WGMMA
        got = fk.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        launched = fk.LAUNCHES_WGMMA - w0
        want = blockwise_ref(q, k, v, causal=True, block_k=plan["key_tile"])
        share = flash_bar_share(got.float(), want.float())
        f32 = blockwise_ref(q.float(), k.float(), v.float(), causal=True)
        rec = {"kernel": "flash_attention", "form": f"bf16_cross_d{d}",
               "shape": f"S{s}_T{t}", "B": b, "Hq": hq, "Hkv": hkv, "S": s, "T": t,
               "D": d, "path": plan["path"], "fma_rows": plan["fma_rows"],
               "wgmma_launches": launched,
               "max_abs_err": float((got.float() - want.float()).abs().max()),
               **share, "max_abs_err_vs_f32": float((got.float() - f32).abs().max())}
        rec["within_tolerance"] = (plan["path"] == "wgmma" and launched == 1
                                   and rec["bar_share"] <= 1.0
                                   and rec["max_abs_err_vs_f32"] <= 2e-2)
        stats["forms"].append(rec)
        say("kernels", **rec)
        ok &= rec["within_tolerance"]
    return ok


#: the bfloat16 forms (shape names of FLASH_FORMS) whose bar is swept over
#: seeds 0-31, and the seeds.  The sweep gates: every (seed, form) inside
#: the bar.  (Until the kernel ran its first block of rows on the FMA pipes,
#: gqa_d128 seed 17's row 30 of (b 1, head 6) passed the bar by 6 %: one P
#: flipped across a bf16 rounding tie by a one-ulp lower row max, found by
#: dumping that row's intermediates beside the plain version's; PERF.md.)
FLASH_SEED_FORMS = ("gqa_d128", "llama_prefill")
FLASH_SEEDS = range(32)
#: (form, seed) pairs of a confirmed fault that the sweep and the cuda-marked
#: sweep leave out: none
FLASH_SEED_FAULTS = ()


def flash_bar_share(got, want):
    """The largest share of the bfloat16 bar (atol FLASH_BF16_ATOL + rtol
    2**-7·|want|; allclose passes at <= 1) that ``got`` takes against
    ``want`` (float32 [B, H, S, D]), and the first (b, h, row) past it."""
    import torch
    share = ((got - want).abs() / (FLASH_BF16_ATOL + 2 ** -7 * want.abs())).amax(-1)
    past = (share > 1.0).nonzero()
    first = None
    if past.numel():
        i = int(torch.argmin(past[:, 2]))
        first = [int(v) for v in past[i]]
    return {"bar_share": float(share.max()), "first_past": first}


def kernels_flash_seeds(dev, stats):
    """The bfloat16 attention kernel against its plain version at its key
    tiles over seeds FLASH_SEEDS at the FLASH_SEED_FORMS forms: the bar
    share of each (seed, form) and the first row past the bar.  False if any
    (seed, form) outside FLASH_SEED_FAULTS passes the bar."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import blockwise_ref

    ok = True
    for form in FLASH_SEED_FORMS:
        _, shape, b, hq, hkv, s, d, window, _ = next(f for f in FLASH_FORMS
                                                     if f[1] == form)
        shares = []
        for seed in FLASH_SEEDS:
            q, k, v = _attn_inputs(b, hq, hkv, s, d, dev, torch.bfloat16, seed)
            got = fk.flash_attention(q, k, v, causal=True, window=window)
            want = blockwise_ref(q, k, v, causal=True, window=window,
                                 block_k=fk.KEY_TILE)
            shares.append({"seed": seed, **flash_bar_share(got.float(), want.float())})
            del q, k, v, got, want
        worst = max(shares, key=lambda r: r["bar_share"])
        failing = [r for r in shares if r["bar_share"] > 1.0]
        ok &= not any((form, r["seed"]) not in FLASH_SEED_FAULTS for r in failing)
        rec = {"kernel": "flash_attention", "form": "bf16_seed_sweep", "shape": shape,
               "seeds": len(shares), "worst": worst, "failing_seeds": len(failing),
               "first_failing": failing[0] if failing else None,
               "bar_shares": [r["bar_share"] for r in shares]}
        stats["flash_seeds"].append(rec)
        say("kernels", **rec)
    torch.cuda.empty_cache()
    return ok


def _sdpa(F, q, k, v):
    """PyTorch's fused attention on the same inputs: the library yardstick,
    timed here and used nowhere in the port."""
    return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)


def _ssd_inputs(bh, heads, s, p, n, dev, seed):
    """The model's distributions at mamba2-780m's init: dt = softplus(N),
    a = -1 (so a chunk's sum of dt·a passes -88: the overflow hazard), B
    and C per sequence ([BH / heads, S, N])."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((bh, s, p), generator=g, device=dev)
    dt = F.softplus(torch.randn((bh, s), generator=g, device=dev))
    a = -torch.ones((bh,), device=dev)
    b = torch.randn((bh // heads, s, n), generator=g, device=dev) * n ** -0.5
    c = torch.randn((bh // heads, s, n), generator=g, device=dev) * n ** -0.5
    return x, dt, a, b, c


#: (shape name, heads per sequence, BH, S, P, N, chunk of the plain
#: version): mamba2-780m's prefill (4 x 48 heads, P 64, N 128), a length
#: that no 64 or 128 divides, and hymba-1.5b's SSM heads (2 x 50, N 16)
SSD_FORMS = (("mamba_prefill", 48, 192, 8192, 64, 128, 128),
             ("mamba_ragged", 48, 192, 1000, 64, 128, 200),
             ("hymba_prefill", 50, 100, 2048, 64, 16, 128))


def _ssd_head_flops(s, p, n):
    """The least FLOP one head's SSD needs over S steps.  Chunked at length
    c, a chunk costs C·Bᵀ, M·x, the inter-chunk product and the state update,
    2·c·(c·N + c·P + 2·P·N), plus P·N to decay the state; the chunk length
    is free, so take the cheapest (c = 1 is the plain recurrence)."""
    return min(-(-s // c) * (2 * c * (c * n + c * p + 2 * p * n) + p * n)
               for c in range(1, min(s, 256) + 1))


#: bf16 passes per product that keep float32's digits (hi·hi + hi·lo +
#: lo·hi): the SSD kernel's own scheme, not the function's least work, so it
#: gives ``bound_split_ms`` beside the bound
SSD_SPLIT_PASSES = 3


def _ptxas_entry(log: str, needle):
    """Registers and spills that ``nvcc -Xptxas -v`` printed for the first
    kernel whose mangled name holds ``needle`` (a string, or a tuple of
    strings that must all appear; None where none does)."""
    import re
    pieces = (needle,) if isinstance(needle, str) else needle
    name, spills = None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), None
            continue
        if name is None or not all(p in name for p in pieces):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            st, ld = spills or (None, None)
            return {"registers": int(m.group(1)), "spill_stores": st, "spill_loads": ld}
    return None


def _ssd_ptxas(x_dtype, bc_dtype, n):
    """``ptxas -v``'s registers and spills for the ssd_wgmma instantiation
    that a call takes (``csrc/ssd.cu``: ssd_wgmma<TX, SPLIT, N>)."""
    import torch
    from repro_torch.kernels.build import library, _target
    library("ssd")
    log = _target("ssd").with_suffix(".log")
    tx = "f" if x_dtype == torch.float32 else "13__nv_bfloat16"
    split = int(bc_dtype == torch.float32)
    needle = f"ssd_wgmmaI{tx}Lb{split}ELi{n}EE"
    return _ptxas_entry(log.read_text(), needle) if log.exists() else None


def kernels_ssd(dev, stats):
    """The SSD kernel against its plain version at atol = rtol = 2e-3
    (tests/test_kernels.py's bar), y and the final state; with bfloat16 x, y
    (rounded to bfloat16 once) against the plain version run in float32
    with rtol one bfloat16 ulp, 2**-8.  Each shape with float32 and bfloat16
    x (B and C float32), and mamba2-780m's prefill also with B and C in
    bfloat16 as its model gives them.  The shared memory the built kernel
    sets must be what the wrapper's plan() states."""
    import torch
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    ok = True
    for shape, heads, bh, s, p, n, chunk in SSD_FORMS:
        x, dt, a, b, c = _ssd_inputs(bh, heads, s, p, n, dev, seed=s)
        forms = [("f32", "f32"), ("bf16", "f32")]
        if shape == "mamba_prefill":
            forms.append(("bf16", "bf16"))
        for xt, bct in forms:
            xin = x if xt == "f32" else x.to(torch.bfloat16)
            bin_, cin = (b, c) if bct == "f32" else (b.to(torch.bfloat16),
                                                     c.to(torch.bfloat16))
            bfull = torch.repeat_interleave(bin_, heads, dim=0)
            cfull = torch.repeat_interleave(cin, heads, dim=0)
            want_y, want_st = ssd_chunked_ref(xin.float(), dt, a, bfull, cfull,
                                              chunk=chunk, return_state=True)
            kern = lambda: sk.ssd_scan(xin, dt, a, bin_, cin, return_state=True)  # noqa: E731
            plain = lambda: ssd_chunked_ref(xin, dt, a, bfull, cfull,            # noqa: E731
                                            chunk=chunk, return_state=True)
            plan = sk.plan(xin.dtype, p, n, bin_.dtype)
            assert sk.wgmma_smem(xin.dtype, n, bin_.dtype) == plan["smem"], (shape, plan)
            n0 = sk.LAUNCHES
            y, st = kern()
            torch.cuda.synchronize()
            assert sk.LAUNCHES == n0 + 1, "ssd_scan did not launch the kernel"
            rtol = 2e-3 if xt == "f32" else 2.0 ** -8
            good = (bool(torch.allclose(y.float(), want_y, atol=2e-3, rtol=rtol))
                    and bool(torch.allclose(st, want_st, atol=2e-3, rtol=2e-3))
                    and bool(torch.isfinite(y).all()))
            err = max(float((y.float() - want_y).abs().max()),
                      float((st - want_st).abs().max()))
            item, bc_item = xin.element_size(), bin_.element_size()
            # x read and y written in x's dtype; dt and a read and the state
            # written in float32; B and C (per sequence) read in their dtype
            moved = (2 * bh * s * p * item + bh * s * 4 + bh * 4
                     + 2 * (bh // heads) * s * n * bc_item + bh * p * n * 4)
            flops = bh * _ssd_head_flops(s, p, n)
            # the least FLOP at the bf16 tensor-core peak
            bound, by = _bound(moved, flops, 2)
            form = f"x_{xt}" + ("_bc_bf16" if bct == "bf16" else "")
            rec = {"kernel": "ssd_scan", "form": form, "shape": shape, "BH": bh,
                   "S": s, "P": p, "N": n,
                   "plan": {k: plan[k] for k in ("p_split", "blocks_per_head", "chunk",
                                                 "state_rows", "bc_split", "smem")},
                   "ptxas": _ssd_ptxas(xin.dtype, bin_.dtype, n),
                   "max_abs_err": err, "within_tolerance": good,
                   "ms": cuda_ms(kern, reps=5), "plain_ms": wall_ms(plain),
                   "bound_ms": bound, "bound_by": by,
                   # the kernel's three bf16 passes a product at the bf16 peak
                   "bound_split_ms": _bound(moved, SSD_SPLIT_PASSES * flops, 2)[0],
                   # the earlier FMA bound: the least FLOP at the float32 peak
                   "bound_fma_ms": _bound(moved, flops, 4)[0], "library_ms": None}
            stats["forms"].append(rec)
            say("kernels", **rec)
            ok &= good
            del y, st, bfull, cfull, want_y, want_st
        del x, dt, a, b, c
    torch.cuda.empty_cache()
    return ok


#: the ring-scan engine's shapes, name -> (n_ports, m, rows of the mixed
#: batch): hft's (8 ports, 3,707 events), datacenter's (32 ports, 530), the
#: k=8 fat-tree's edge tier flattened (64 ports) and 300 ports (the tail in
#: global memory, port state in shared memory); each at depths 1, 2, 8, 64
#: and 1,024 for every row, and a batch of mixed depths (0 included: the
#: degenerate depth the serial fallback takes, whose scan rows still run)
RING_SHAPES = {"hft": (8, 3707, (1, 2, 8, 64, 1024, 3, 16, 0)),
               "datacenter": (32, 530, (1, 2, 8, 64, 1024, 3, 16, 0)),
               "fattree8_edge": (64, 2001, (1, 8, 64, 1024)),
               "ports300": (300, 777, (1, 2, 8, 1024))}
RING_DEPTHS = (1, 2, 8, 64, 1024)


def ring_chain_step_ns(dev) -> float:
    """ns of one dependent step of the ring scan (the tail read, the ring
    read and write, two maxima and the adds), from CHAIN_STEPS of them on
    one thread, timed with CUDA events."""
    import torch
    from repro_torch.kernels.ring_scan import kernel as rk
    io = torch.tensor([0.0, 1e-8, 0.0, 2e-8, 3e-8, 1e-8], dtype=torch.float64,
                      device=dev)
    ring = torch.zeros(64, dtype=torch.float64, device=dev)
    rk.chain_step(io, ring, 1024, mod=8, depth=8)                 # warm up
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    rk.chain_step(io, ring, CHAIN_STEPS, mod=8, depth=8)
    e1.record()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(io).all()), io
    return e0.elapsed_time(e1) * 1e6 / CHAIN_STEPS


def _incast_inputs():
    """A SHARED-VOQ incast that drops: 8 senders hammer ports 0-3 on a 10
    Gbps link (the reference's shared-cap test trace), stage-4 timeline and
    service times of four SHARED candidates at depths 8 and 16."""
    import numpy as np
    from repro_torch.core import (ForwardTableKind, SchedulerKind, SwitchArch,
                                  VOQKind, bind, compressed_protocol)
    from repro_torch.sim.backannotate import annotate
    from repro_torch.sim.netsim import service_times
    from repro_torch.sim.timeline import stage4_timeline
    from repro_torch.traces import Trace
    n, per_src = 8, 120
    rng = np.random.default_rng(0)
    tr = Trace("incast4",
               np.concatenate([np.arange(per_src) * 2.2e-7 + s * 1e-9
                               for s in range(n)]),
               np.concatenate([np.full(per_src, s) for s in range(n)]),
               np.concatenate([rng.integers(0, 4, per_src) for _ in range(n)]),
               np.full(n * per_src, 200), n, link_gbps=10.0)
    bound = bind(compressed_protocol(addr_bits=4, length_bits=6), flit_bits=256)
    archs = [SwitchArch(n_ports=n, bus_bits=bw, fwd=ForwardTableKind.FULL_LOOKUP,
                        voq=VOQKind.SHARED, sched=SchedulerKind.RR, voq_depth=d,
                        addr_bits=4) for bw in (128, 512) for d in (8, 16)]
    tl4 = stage4_timeline(tr, n, bound.header_bytes, 0.0)
    svc = np.empty((len(archs), tl4.now.size))
    pipe = np.empty(len(archs))
    for b, a in enumerate(archs):
        svc[b], pipe[b] = service_times(a, annotate(a, bound, source="model"),
                                        tl4.wire, tr.link_gbps * 1e9)
    depth = np.array([a.voq_depth for a in archs])
    return (tl4.now, tl4.src_o.astype(np.int32), tl4.dst_o.astype(np.int32),
            svc[:, tl4.order], pipe, depth)


def kernels_ring_scan(dev, stats):
    """The ring-scan stage-4 kernel against its plain version, bitwise
    (end and admit), at each RING_SHAPES shape and depth set and on the
    incast; ms per call and kernel alone (``launch_ms``), ptxas
    registers and spills, the chain bound (m steps at the measured step
    latency) and the bytes bound."""
    import numpy as np
    import torch
    from repro_torch.kernels.build import _target
    from repro_torch.kernels.ring_scan import kernel as rk
    from repro_torch.kernels.ring_scan import ref as rref
    from repro_torch.kernels.ring_scan import ring_rows_per_chunk, ring_scan

    t_step = ring_chain_step_ns(dev)
    log = _target("ring_scan").with_suffix(".log")
    log = log.read_text() if log.exists() else ""
    cases = []
    for shape, (n, m, mixed) in RING_SHAPES.items():
        rng = np.random.default_rng(n)
        t, src, dst, svc, pipe, _ = timeline(rng, m, n, len(mixed), f64=True)
        for name, depths in [*((f"d{d}", (d,) * len(mixed)) for d in RING_DEPTHS),
                             ("mixed", mixed)]:
            cases.append((shape, name, n, t, src, dst, svc, pipe,
                          np.asarray(depths)))
    t, src, dst, svc, pipe, depth = _incast_inputs()
    cases.append(("incast_shared", "d8_d16", 8, t, src, dst, svc, pipe, depth))
    ok = True
    for shape, name, n, t, src, dst, svc, pipe, depth in cases:
        b, m = svc.shape
        mod = np.minimum(np.maximum(depth, 1), m).astype(np.int32)
        d_max = 1 << int(int(mod.max()) - 1).bit_length()
        T = lambda a: torch.tensor(a, device=dev)          # noqa: E731
        args = (T(t), T(src), T(dst), T(svc), T(pipe),
                T(depth.astype(np.int32)), T(mod))
        kern = lambda: ring_scan(*args, n_ports=n, d_max=d_max)   # noqa: E731
        got = kern()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = rref.ring_scan_ref(*args, n_ports=n, d_max=d_max)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        moved = m * (8 + 4 + 4) + b * (8 + 4 + 4) + b * m * (8 + 8 + 1)
        ops = b * m * 5          # t + pipe, two maxima, + s, oldest > t
        bound, by = _bound(moved, ops, 8)
        smem_tail = rk.tail_in_smem(n)
        rec = {"kernel": "ring_scan", "form": f"ring_{shape}_{name}",
               "shape": shape, "B": b, "m": m, "n_ports": n, "d_max": d_max,
               "depths": sorted(set(depth.tolist())),
               "drops": int((~want[1]).sum()),
               "chunks": -(-b // ring_rows_per_chunk(n, d_max)),
               "tail": "shared" if smem_tail else "global",
               "ms": cuda_ms(kern, reps=5),
               "kernel_ms": launch_ms(kern, 10),
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "t_step_ns": t_step, "chain_bound_ms": m * t_step * 1e-6,
               "chain_bound_by": "m steps",
               "ptxas": _ptxas_entry(log, f"16ring_scan_kernelILi{scan_slots(n)}"
                                          f"ELb{int(smem_tail)}EE"),
               "library_ms": None}
        ok &= _record(stats, rec, got, want)
        del args, got, want
    torch.cuda.empty_cache()
    return ok


def _counters():
    """kernel name -> (the module of its wrapper, the counter's name)"""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.islip import kernel as ik
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.netsim import kernel as nk
    from repro_torch.kernels.switch_loop import kernel as slk
    from repro_torch.kernels.parser import kernel as pk
    from repro_torch.kernels.quant_pack import kernel as qk
    from repro_torch.kernels.ring_scan import kernel as rk
    from repro_torch.kernels.xbar import kernel as xk
    return {"xbar_scan": (xk, "LAUNCHES"), "netsim_replay": (nk, "LAUNCHES"),
            "ring_scan": (rk, "LAUNCHES"),
            "islip_schedule": (ik, "LAUNCHES"),
            "switch_loop": (slk, "LAUNCHES"),
            "parse_headers": (pk, "LAUNCHES"),
            "quantize": (qk, "QUANTIZE_LAUNCHES"),
            "dequantize": (qk, "DEQUANTIZE_LAUNCHES"),
            "flash_attention": (fk, "LAUNCHES"),
            "flash_attention_wgmma": (fk, "LAUNCHES_WGMMA"),
            "ssd_scan": (sk, "LAUNCHES")}


def _reset_counters():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _read_counters():
    return {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}


def phase_path(dev, stats):
    """The main paths on the card, each with fresh launch counters."""
    failures = (path_golden(dev, stats) + path_switch(dev, stats)
                + path_comm(dev, stats) + path_serving(dev, stats)
                + path_served(dev, stats) + path_resume(dev, stats))
    if failures:
        raise AssertionError(f"path failures: {failures}")


def path_golden(dev, stats):
    """(a) run_scenario vs the golden reports at their settings, then the
    single-switch goldens again with use_kernel="off".  xbar and netsim
    must launch (on fattree_dc too); on the off runs ring_scan must launch
    and netsim_replay must not."""
    from repro_torch.api import Scenario, run_scenario

    failures = []
    _reset_counters()
    runs = [(name, None) for name in GOLDEN] + [(n, "off") for n in GOLDEN_OFF]
    for name, use_kernel in runs:
        with open(os.path.join(ROOT, "tests", "golden", f"{name}.json")) as f:
            want = json.load(f)
        scen = Scenario.from_dict(want["scenario"])
        if use_kernel is not None:
            scen = scen.override(use_kernel=use_kernel)
        before = _read_counters()
        report = run_scenario(scen, device=dev)
        got = json.loads(json.dumps(report.to_dict()))
        after = _read_counters()
        run = {k: after[k] - before[k] for k in after}
        errors = []
        if use_kernel is not None:
            field = got["scenario"]["fidelity"].pop("use_kernel", None)
            if field != use_kernel:
                errors.append(f"scenario.fidelity.use_kernel: {field!r}")
            if not (run["ring_scan"] > 0 and run["netsim_replay"] == 0):
                errors.append(f"ring_scan did not run, or netsim_replay did: {run}")
        elif name == "fattree_dc" and not (run["xbar_scan"] > 0
                                           and run["netsim_replay"] > 0):
            errors.append(f"xbar/netsim did not run on the fabric: {run}")
        errors += diff_reports(got, want)
        say("path", scenario=name, use_kernel=use_kernel or "as recorded",
            best=got["best"], mismatches=len(errors), first_mismatches=errors[:5],
            wall_s=report.wall_time_s, stage2_s=report.stage2_time_s,
            stage4_s=report.stage4_time_s, launches=run)
        if errors:
            failures.append(f"{name} ({use_kernel or 'as recorded'})")
    launches = _read_counters()
    stats["launches"].update({k: launches[k] for k in
                              ("xbar_scan", "netsim_replay", "ring_scan")})
    say("path", path="golden", launches=launches)
    if not (launches["xbar_scan"] > 0 and launches["netsim_replay"] > 0
            and launches["ring_scan"] > 0):
        failures.append(f"xbar/netsim/ring_scan did not run on the golden "
                        f"path: {launches}")
    return failures


#: path (e): the DSE service's widths
SERVED = dict(slots=4, batch_width=64, verify_width=16)


def _golden_scenario(name):
    from repro_torch.api import Scenario
    with open(os.path.join(ROOT, "tests", "golden", f"{name}.json")) as f:
        want = json.load(f)
    return Scenario.from_dict(want["scenario"]), want


def _widths(before, after, arg):
    """{B: calls} of a tracked engine's calls between two ``call_counts``
    snapshots, B the leading dimension of its tensor argument ``arg``."""
    out = {}
    for key, n in after.items():
        n -= before.get(key, 0)
        if n:
            b = dict(key)[arg][0][0]
            out[b] = out.get(b, 0) + n
    return out


def path_served(dev, stats):
    """(e) the DSE service on the card: each golden as recorded twice and
    hft with trace seed 1, interleaved; every report equal to its golden
    (the seeded one to run_scenario, run before the counters' window), the
    repeats answered from the report cache, no request error; every stage-2
    engine call of the wave at the chunk width and every stage-4 round-1
    call at most the verify width (the fixed point runs a chunk's distinct
    rows, split by header width, as the JAX package's does), read from the
    call keys; xbar and netsim must launch in the wave; then a second wave
    on a fresh engine at the same widths that adds no call key
    (retrace_guard(expect=0))."""
    from repro_torch.analysis import retrace_guard
    from repro_torch.analysis.retrace import call_counts
    from repro_torch.api import DSEServeEngine, run_scenario, strip_times

    failures = []
    scen = {name: _golden_scenario(name) for name in GOLDEN}
    seeded = scen["hft"][0].override(trace_params={"seed": 1})
    want_seeded = strip_times(run_scenario(seeded, device=dev).to_dict())
    order = [*GOLDEN, "hft@1", *GOLDEN]
    engines = (("surrogate.engine", "svc"), ("netsim.kernel.round1", "svc"))
    keys0 = {name: call_counts(name) for name, _ in engines}
    _reset_counters()
    eng = DSEServeEngine(device=dev, **SERVED)
    t0 = time.perf_counter()
    reqs = [(n, eng.submit(seeded if n == "hft@1" else scen[n][0])) for n in order]
    eng.run_until_drained()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    widths = {name: _widths(keys0[name], call_counts(name), arg)
              for name, arg in engines}
    st = eng.stats()
    for name, req in reqs:
        if req.error is not None:
            failures.append(f"served {name}: {req.error}")
            continue
        errors = (diff_reports(req.report, scen[name][1]) if name != "hft@1"
                  else (["differs from run_scenario"]
                        if strip_times(req.report) != want_seeded else []))
        if errors:
            failures.append(f"served {name}: {errors[:3]}")
        say("path", path="served", scenario=name, cached=req.cached,
            wall_time_s=req.wall_time_s, mismatches=len(errors),
            best=req.report.get("best"))
    repeats = len(order) - len(set(order))
    if st["report_hits"] != repeats or st["errors"]:
        failures.append(f"served: {st['report_hits']} report-cache hits for "
                        f"{repeats} repeats, {st['errors']} errors")
    s2, s4 = widths["surrogate.engine"], widths["netsim.kernel.round1"]
    if set(s2) != {SERVED["batch_width"]}:
        failures.append(f"served: stage-2 engine calls at widths {s2}, not "
                        f"only {SERVED['batch_width']}")
    if not s4 or max(s4) > SERVED["verify_width"]:
        failures.append(f"served: stage-4 round-1 calls at widths {s4}, not "
                        f"at most {SERVED['verify_width']}")
    unique = len(set(order))
    # the second wave: a fresh engine (empty caches) at the same widths
    try:
        with retrace_guard(expect=0) as guard:
            again = DSEServeEngine(device=dev, **SERVED)
            for name in sorted(set(order)):
                again.submit(seeded if name == "hft@1" else scen[name][0])
            second = again.run_until_drained()
        new_keys = guard.deltas()
    except AssertionError as e:
        new_keys = str(e)
        failures.append(f"served second wave: {e}")
        second = []
    if any(r.error for r in second):
        failures.append("served second wave: a request errored")
    rec = {"path": "served", "requests": len(order), "unique": unique,
           "wall_s": wall, "requests_per_s": len(order) / wall,
           "wall_per_unique_request_s": wall / unique,
           "stage2_cands_per_sec": st["stage2_cands_per_sec"],
           "stage4_cands_per_sec": st["stage4_cands_per_sec"],
           "stage2_rows": st["stage2_rows"], "stage2_pad_rows": st["stage2_pad_rows"],
           "stage2_chunks": st["stage2_chunks"], "stage4_rows": st["stage4_rows"],
           "stage4_pad_rows": st["stage4_pad_rows"], "stage4_chunks": st["stage4_chunks"],
           "report_hits": st["report_hits"], "errors": st["errors"],
           "timeline": st["timeline"], "stage2_engine_widths": s2,
           "stage4_round1_widths": s4, "second_wave_new_keys": new_keys,
           "launches": launches, **SERVED}
    stats["served"] = rec
    say("path", **rec)
    if not (launches["xbar_scan"] > 0 and launches["netsim_replay"] > 0):
        failures.append(f"xbar/netsim did not run on the served path: {launches}")
    return failures


def path_resume(dev, stats):
    """(f) hft_nsga2 at registry size, stopped after 2 generations into a
    temporary checkpoint directory and resumed by run_scenario: the report
    equals the golden and the uninterrupted run (the checkpoint directory
    and the resumed note the only fields allowed to differ), and xbar and
    netsim launch between the stop and the resumed report; then check over
    the registry, every scenario clean."""
    import tempfile
    from repro_torch.analysis import check_scenario, exit_code
    from repro_torch.api import build_problem, registry, run_scenario
    from repro_torch.core.search import run_search

    failures = []
    scen, want = _golden_scenario("hft_nsga2")
    _reset_counters()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as ck:
        spec = dataclasses.replace(scen.search, checkpoint_dir=ck)
        ckpt = scen.override(search=spec)
        problem, sla, _ = build_problem(ckpt, device=dev)
        part = run_search(problem, spec, sla, delta=ckpt.fidelity.delta,
                          checkpoint_dir=ck, max_generations_this_run=2)
        resumed = run_scenario(ckpt, resume=True, device=dev)
        got = json.loads(json.dumps(resumed.to_dict()))
    t_resume = time.perf_counter() - t0
    launches = _read_counters()
    full = json.loads(json.dumps(run_scenario(scen, device=dev).to_dict()))
    got["scenario"]["search"]["checkpoint_dir"] = None
    notes = got["stages"][0]["notes"]
    errors = [] if "resumed=True" in notes else [f"not resumed: {notes}"]
    got["stages"][0]["notes"] = [n.replace("resumed=True", "resumed=False")
                                 for n in notes]
    errors += diff_reports(got, want)
    if _without_times(got) != _without_times(full):
        errors.append("the resumed report differs from the uninterrupted run")
    say("path", path="resume", scenario="hft_nsga2", stopped_after=part.generations,
        resumed_notes=notes, mismatches=len(errors), first_mismatches=errors[:5],
        stop_and_resume_time_s=t_resume, launches=launches)
    if errors or part.generations != 2:
        failures.append(f"resume: {errors[:3]}")
    if not (launches["xbar_scan"] > 0 and launches["netsim_replay"] > 0):
        failures.append(f"xbar/netsim did not run on the resume path: {launches}")
    diags = {name: check_scenario(registry[name]) for name in registry.names()}
    dirty = sorted(n for n, d in diags.items() if exit_code(d))
    say("path", path="check", scenarios=len(diags), dirty=dirty)
    if dirty:
        failures.append(f"check found problems in {dirty}")
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
    escalated to the cycle-level switch; switch_loop must launch, the
    batch parser must not (the loop parses at ingress)."""
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
    stats["launches"].update({k: launches[k] for k in
                              ("switch_loop", "parse_headers", "islip_schedule")})
    say("path", path="switch", launches=launches)
    # the switch parses at ingress inside switch_loop (csrc/switch_loop.cu),
    # as the reference's cycle step does: the batch parser has no launch here
    if not (launches["switch_loop"] > 0 and launches["parse_headers"] == 0):
        failures.append(f"switch_loop did not run, or parse_headers did, on the "
                        f"switch path: {launches}")
    return failures


def _comm_fixture(name):
    import numpy as np
    base = os.path.join(ROOT, "tests", "torch_golden", name)
    with open(base + ".json") as f:
        doc = json.load(f)
    with np.load(base + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    return doc, arrays


def _bf16_bits_to_f32(a):
    import numpy as np
    return (np.asarray(a).astype(np.uint32) << 16).view(np.float32)


def path_comm(dev, stats):
    """(c) the comm domain with the reference's inputs carried across;
    quantize and dequantize must launch."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.api import Scenario
    from repro_torch.models import MoEOptions
    from repro_torch.models.moe import apply_moe

    failures = []
    _reset_counters()
    for name in COMM_RUNS:
        doc, arrays = _comm_fixture(name)
        before = _read_counters()
        report = convert.run_comm_scenario(
            Scenario.from_dict(doc["report"]["scenario"]), arrays, device=dev)
        got = json.loads(json.dumps(report.to_dict()))
        errors = diff_reports(got, doc["report"])
        verified = [{"candidate": a.short(), "drop_frac": float(v.drop_rate),
                     "expert_load": np.asarray(v.meta["expert_load"]).tolist()}
                    for a, v, _, _ in report.result.evaluated]
        if verified != doc["verified"]:
            errors.append("verified candidates' expert loads / drop rates differ")
        if name == "comm_small":
            with open(os.path.join(ROOT, "tests", "golden", "comm_small.json")) as f:
                errors += [f"golden: {e}" for e in diff_reports(got, json.load(f))]
        after = _read_counters()
        rec = {"comm": name, "best": got["best"], "mismatches": len(errors),
               "first_mismatches": errors[:5], "wall_s": report.wall_time_s,
               "stage2_s": report.stage2_time_s,
               "stage4_s": report.stage4_time_s,
               "verified": len(verified),
               "launches": {k: after[k] - before[k] for k in after}}
        stats["comm"].append(rec)
        say("path", **rec)
        if errors:
            failures.append(name)
    launches = _read_counters()
    stats["launches"].update({k: launches[k] for k in ("quantize", "dequantize")})
    say("path", path="comm", launches=launches)
    if not (launches["quantize"] > 0 and launches["dequantize"] > 0):
        failures.append(f"quantize/dequantize did not run on the comm path: {launches}")

    # comm_small's layer output: within Y_RTOL of the reference's, and the
    # same from run to run on the card
    doc, arrays = _comm_fixture("comm_small")
    prob = convert.comm_problem(Scenario.from_dict(doc["report"]["scenario"]),
                                arrays, device=dev)
    for payload, kw in doc["apply_moe"].items():
        run = lambda: apply_moe(prob.params, prob.cfg, prob.plan, None,  # noqa: E731
                                prob.sample_x, MoEOptions(**kw))[0]
        y1, y2 = run(), run()
        want = _bf16_bits_to_f32(arrays[f"y_{payload}"])
        got = y1.float().cpu().numpy()
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        same = bool(torch.equal(y1, y2))
        ok = bool(np.isfinite(got).all()) and err <= Y_RTOL * scale and same
        say("path", comm="comm_small apply_moe", payload=payload,
            max_abs_err=err, max_abs_y=scale, rtol=Y_RTOL,
            identical_across_runs=same, ok=ok)
        if not ok:
            failures.append(f"comm_small apply_moe {payload}")
    return failures


def _kernel_timer(log, mods=None):
    """Bracket each launch of the kernels whose wrappers ``mods`` names
    (name -> the wrapper's module; default: the attention and SSD kernels)
    with CUDA events (no host sync) by wrapping the wrappers; returns the
    undo."""
    import torch
    if mods is None:
        from repro_torch.kernels.flash_attention import kernel as fk
        from repro_torch.kernels.ssd import kernel as sk
        mods = {"flash_attention": fk, "ssd_scan": sk}
    real = {name: (mod, getattr(mod, name)) for name, mod in mods.items()}

    def wrap(name, fn):
        def timed(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            log.append((name, e0, e1))
            return out
        return timed

    for name, (mod, fn) in real.items():
        setattr(mod, name, wrap(name, fn))

    def undo():
        for name, (mod, fn) in real.items():
            setattr(mod, name, fn)
    return undo


def _kernel_ms(log, start):
    out = {}
    for name, e0, e1 in log[start:]:
        out[name] = out.get(name, 0.0) + e0.elapsed_time(e1)
    return out


def path_serving(dev, stats):
    """(d) the model serving path at full width: llama3.2-1b and
    mamba2-780m prefill (all layers) of 4 x 8,192 tokens, ServeEngine on
    llama3.2-1b, and both models' prefill against the reference's
    full-width fixtures; flash_attention and ssd_scan must launch once per
    attention / SSM layer."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import SINGLE_POD_PLAN as PLAN
    from repro_torch.models import transformer as T

    failures = []
    t_path = time.perf_counter()
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log = []
    undo = _kernel_timer(log)
    try:
        _reset_counters()
        b, s = PREFILL_BS
        for arch, layers in SERVE_PREFILL.items():
            cfg = get_config(arch)
            # llama's bf16 D 64 attention takes the wgmma path every layer;
            # mamba's SSD (x, B and C in bf16) is one call a layer
            want_launches = ({"flash_attention": layers, "flash_attention_wgmma": layers}
                             if cfg.has_attention else {"ssd_scan": layers})
            t0 = time.perf_counter()
            params = T.init_params(torch.Generator(dev).manual_seed(0), cfg, PLAN)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            tok = torch.randint(0, cfg.vocab, (b, s), device=dev,
                                generator=torch.Generator(dev).manual_seed(1))
            for run in (1, 2):
                before, n_log = _read_counters(), len(log)
                torch.cuda.reset_peak_memory_stats(dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, state = T.prefill(params, cfg, PLAN, None, {"tokens": tok})
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                after = _read_counters()
                launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
                kms = _kernel_ms(log, n_log)
                ok = (tuple(logits.shape) == (b, cfg.vocab)
                      and bool(torch.isfinite(logits.float()).all())
                      and int(state["pos"]) == s
                      and launches == want_launches)
                rec = {"serving": f"{arch} prefill", "run": run, "layers": layers,
                       "B": b, "S": s, "wall_s": wall, "tokens_per_s": b * s / wall,
                       "launches": launches, "kernel_ms": kms,
                       "kernel_share": sum(kms.values()) / (wall * 1e3),
                       "peak_mem_mb": torch.cuda.max_memory_allocated(dev) / 2 ** 20,
                       "init_s": init_s, "ok": ok}
                stats["serving"].append(rec)
                say("path", **rec)
                if not ok:
                    failures.append(f"{arch} prefill run {run}")
                del logits, state
            if arch == "llama3.2-1b":
                failures += _serve_engine(cfg, params, dev, stats)
            del params, tok
            torch.cuda.empty_cache()
        for stem, arch in MODEL_FIXTURES.items():
            failures += _model_fixture(stem, arch, dev, stats)
    finally:
        undo()
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    launches = _read_counters()
    stats["launches"].update({k: launches[k] for k in ("flash_attention",
                                                       "flash_attention_wgmma", "ssd_scan")})
    say("path", path="serving", launches=launches,
        seconds=time.perf_counter() - t_path)
    if not (launches["flash_attention"] > 0 and launches["ssd_scan"] > 0):
        failures.append(f"flash_attention/ssd_scan did not run on the serving path: "
                        f"{launches}")
    return failures


def _serve_engine(cfg, params, dev, stats):
    """The launcher's serving loop (``launch.serve.serve``) at its defaults:
    every request served with max_new tokens, each a valid token id."""
    import torch
    from repro_torch.launch import serve as launcher

    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    res = launcher.serve(cfg, params, **SERVE_ENGINE)
    done, wall, ticks = res.pop("done"), res["wall_time_s"], res["ticks"]
    ok = (res["served"] == SERVE_ENGINE["requests"]
          and all(len(r.out) == r.max_new and all(0 <= t < cfg.vocab for t in r.out)
                  for r in done))
    rec = {"serving": f"{cfg.name} ServeEngine", **SERVE_ENGINE, **res,
           "ms_per_tick": wall * 1e3 / max(ticks, 1),
           "tokens_per_s": res["tokens"] / wall,
           "peak_mem_mb": torch.cuda.max_memory_allocated(dev) / 2 ** 20, "ok": ok}
    stats["serving"].append(rec)
    say("path", **rec)
    return [] if ok else [f"{cfg.name} ServeEngine"]


def _model_fixture(stem, arch, dev, stats):
    """The card's prefill, from the fixture's NumPy-seeded weights, against
    the reference's logits, elementwise at the atol = rtol the fixture
    records for each dtype; ``worst`` is the largest |diff| / (atol +
    rtol·|want|), which passes at or below 1."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import SINGLE_POD_PLAN as PLAN
    from repro_torch.models import transformer as T

    meta, arrays = _comm_fixture(stem)
    cfg = dataclasses.replace(get_config(arch), n_layers=meta["n_layers"],
                              attn_impl=meta["attn_impl"])
    t0 = time.perf_counter()
    params = convert.model_params(convert.seeded_model_arrays(cfg, meta["seed"]), dev)
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    tok = torch.from_numpy(arrays["tokens"]).long().to(dev)
    failures = []
    for dtype, key in (("float32", "logits_f32"), ("bfloat16", "logits_bf16")):
        logits, _ = T.prefill(params, dataclasses.replace(cfg, dtype=dtype), PLAN, None,
                              {"tokens": tok})
        got = logits.float().cpu().numpy()
        want = arrays[key] if key == "logits_f32" else _bf16_bits_to_f32(arrays[key])
        tol = meta["tolerance"][dtype]
        diff = np.abs(got - want)
        worst = float((diff / (tol + tol * np.abs(want))).max())
        ok = bool(np.isfinite(got).all()) and worst <= 1.0
        rec = {"serving": f"{stem} fixture", "dtype": dtype, "layers": meta["n_layers"],
               "S": meta["seq"], "max_abs_err": float(diff.max()),
               "max_abs_logit": float(np.abs(want).max()), "worst": worst,
               "tolerance": tol, "weights_s": weights_s, "ok": ok}
        stats["serving"].append(rec)
        say("path", **rec)
        if not ok:
            failures.append(f"{stem} {dtype}")
    del params
    torch.cuda.empty_cache()
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
    from repro_torch.sim import timeline as memo

    with open(os.path.join(ROOT, "tests", "golden", "hft.json")) as f:
        scen = Scenario.from_dict(json.load(f)["scenario"])
    kw = {"delta": scen.fidelity.delta, "top_k": scen.fidelity.top_k}

    # (a) the exhaustive DSE on a 40 ms capture; the timeline memo cleared,
    # so this run builds its own stage-2 and stage-4 timelines
    memo.clear()
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
    rec = {"run": "run_dse hft duration_s=0.04", "engine": "auto", "order": 1,
           "events": m,
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
    scale_engines_dse(dev, stats, scen, kw, rec, c4, r4)
    del c4, r4

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
    del problem, ev, log
    torch.cuda.empty_cache()
    scale_fattree(dev, stats)
    scale_moe(dev, stats)


def _same_verify(a, b) -> bool:
    """Two stage-4 results are the same: drops, every metric, the latency
    arrays bitwise, the fallback flags."""
    import numpy as np
    return (a.drop_rate == b.drop_rate and a.p99_latency_ns == b.p99_latency_ns
            and a.mean_latency_ns == b.mean_latency_ns
            and a.throughput_gbps == b.throughput_gbps
            and all(a.meta.get(k) == b.meta.get(k)
                    for k in ("delivered", "fallback", "shared_cap_fallback"))
            and all(np.array_equal(a.meta[k], b.meta[k], equal_nan=True)
                    for k in ("latency_ns", "latency_full_ns")))


#: the stage-4 engines' order in the scale phase's comparisons: each runs
#: first once and second once, every run after a cleared timeline memo
ENGINE_ORDER = ("auto", "off", "off", "auto")


def _engine_walls(recs, key):
    """engine -> that field of each of its runs, in run order."""
    out = {}
    for r in recs:
        out.setdefault(r["engine"], []).append(r[key])
    return out


def scale_engines_dse(dev, stats, scen, kw, first, c4_auto, r4_auto):
    """run_dse on the 40 ms hft capture under both stage-4 engines in the
    order ENGINE_ORDER (``first`` is the auto run already taken), the
    timeline memo cleared before each run: every stage-4 result equal to
    the first auto run's; the ring scan launches only on the off runs."""
    import torch
    from repro_torch.api import build_problem
    from repro_torch.core.dse import run_dse
    from repro_torch.kernels.netsim import kernel as nk
    from repro_torch.kernels.ring_scan import kernel as rk
    from repro_torch.sim import timeline as memo

    recs = [first]
    for order, use_kernel in enumerate(ENGINE_ORDER[1:], start=2):
        memo.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        problem, sla, budget = build_problem(
            scen.override(trace_params={"duration_s": 0.04}, use_kernel=use_kernel),
            device=dev)
        log, events = {}, []
        _timed(problem, "surrogate_batch", log)
        _timed(problem, "verify_batch", log)
        undo = _kernel_timer(events, {"ring_scan": rk})
        r0, n0 = rk.LAUNCHES, nk.LAUNCHES
        try:
            t0 = time.perf_counter()
            result = run_dse(problem, sla, budget, **kw)
            t_dse = time.perf_counter() - t0
        finally:
            undo()
        (s2, _, _), = log["surrogate_batch"]
        (s4, c4, r4), = log["verify_batch"]
        same = ([c.short() for c in c4] == [c.short() for c in c4_auto]
                and all(_same_verify(a, b) for a, b in zip(r4, r4_auto)))
        launches = {"ring_scan": rk.LAUNCHES - r0, "netsim_replay": nk.LAUNCHES - n0}
        rec = {"run": f"run_dse hft duration_s=0.04 use_kernel={use_kernel}",
               "engine": use_kernel, "order": order,
               "events": len(problem.trace), "stage4_rows": len(c4),
               "best": result.best.short() if result.best is not None else None,
               "run_dse_s": t_dse, "stage2_s": s2, "stage4_s": s4,
               "ring_scan_ms": _kernel_ms(events, 0).get("ring_scan", 0.0),
               "launches": launches, "stage4_equal_to_auto": same,
               "peak_device_mb": torch.cuda.max_memory_allocated(dev) / 2**20}
        stats["scale"].append(rec)
        say("scale", **rec)
        recs.append(rec)
        del problem, result, log, c4, r4
        ring_ok = (launches["ring_scan"] > 0) == (use_kernel == "off")
        if not same or not ring_ok:
            raise AssertionError(f"run_dse use_kernel={use_kernel} differs from the "
                                 f"first auto run, or the ring scan ran where it "
                                 f"should not (or not where it should): {launches}")
    say("scale", run="run_dse 40 ms by engine (order auto, off, off, auto)",
        stage2_s=_engine_walls(recs, "stage2_s"), stage4_s=_engine_walls(recs, "stage4_s"),
        run_dse_s=_engine_walls(recs, "run_dse_s"))


#: a fabric at a deployment's width: fattree_dc's scenario on a k=8 fat-tree
#: (32 hosts; 8 edge and 4 core switches of 8 ports), its datacenter trace
#: on 32 hosts for 10 ms, the protocol's address field widened to 5 bits
FATTREE8 = {"topology": {"kind": "fattree", "params": {"k": 8}},
            "trace": {"generator": "datacenter",
                      "params": {"n_ports": 32, "seed": 0, "duration_s": 0.01}},
            "addr_bits": 5}


def _without_times(doc):
    """A report with every *_time_s field removed, for exact comparison."""
    if isinstance(doc, dict):
        return {k: _without_times(v) for k, v in doc.items()
                if not k.endswith("_time_s")}
    if isinstance(doc, list):
        return [_without_times(v) for v in doc]
    return doc


def scale_fattree(dev, stats):
    """The k=8 fat-tree under both stage-4 engines in the order
    ENGINE_ORDER, the timeline memo cleared before each run: every report
    equal to the first's apart from *_time_s and fidelity.use_kernel."""
    import torch
    from repro_torch.api import Scenario, run_scenario
    from repro_torch.kernels.netsim import kernel as nk
    from repro_torch.kernels.ring_scan import kernel as rk
    from repro_torch.kernels.xbar import kernel as xk
    from repro_torch.sim import timeline as memo

    with open(os.path.join(ROOT, "tests", "golden", "fattree_dc.json")) as f:
        base = json.load(f)["scenario"]
    base.update(topology=FATTREE8["topology"], trace=FATTREE8["trace"])
    base["protocol"]["params"]["addr_bits"] = FATTREE8["addr_bits"]
    reports, recs = [], []
    for order, use_kernel in enumerate(ENGINE_ORDER, start=1):
        d = json.loads(json.dumps(base))
        d["fidelity"]["use_kernel"] = use_kernel
        memo.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        counts = (xk.LAUNCHES, nk.LAUNCHES, rk.LAUNCHES)
        report = run_scenario(Scenario.from_dict(d), device=dev)
        got = json.loads(json.dumps(report.to_dict()))
        got["scenario"]["fidelity"].pop("use_kernel", None)
        reports.append(got)
        rec = {"run": f"fattree k=8 datacenter 32 hosts 10 ms use_kernel={use_kernel}",
               "engine": use_kernel, "order": order,
               "events": len(report.problem.trace),
               "stage2_candidates": report.stage2_candidates,
               "stage4_candidates": report.stage4_candidates,
               "best": got["best"], "best_verify": got["best_verify"],
               "wall_s": report.wall_time_s, "stage2_s": report.stage2_time_s,
               "stage4_s": report.stage4_time_s,
               "launches": {k: now - then for k, now, then in zip(
                   ("xbar_scan", "netsim_replay", "ring_scan"),
                   (xk.LAUNCHES, nk.LAUNCHES, rk.LAUNCHES), counts)},
               "peak_device_mb": torch.cuda.max_memory_allocated(dev) / 2**20}
        stats["scale"].append(rec)
        say("scale", **rec)
        recs.append(rec)
        del report
    errors = []
    for other in reports[1:]:
        errors += diff_reports(other, reports[0])
        if _without_times(other) != _without_times(reports[0]):
            errors.append("the reports differ outside *_time_s")
    say("scale", run="fattree k=8 by engine (order auto, off, off, auto)",
        mismatches=len(errors), first_mismatches=errors[:5],
        wall_s=_engine_walls(recs, "wall_s"), stage2_s=_engine_walls(recs, "stage2_s"),
        stage4_s=_engine_walls(recs, "stage4_s"))
    if errors or reports[0]["best"] is None:
        raise AssertionError(f"the k=8 fat-tree differs between the engines: "
                             f"{errors[:5]}")
    torch.cuda.empty_cache()


def scale_moe(dev, stats):
    """autotune_moe on one full-width MoE layer of SCALE_ARCH."""
    import torch
    from repro_torch.comm.dse_comm import CommDSEProblem, autotune_moe, route_trace
    from repro_torch.configs import get_config
    from repro_torch.kernels.quant_pack import kernel as qk
    from repro_torch.models import SINGLE_POD_PLAN
    from repro_torch.models.moe import apply_moe, init_moe

    cfg = get_config(SCALE_ARCH)
    b, s = SCALE_TOKENS
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_moe(torch.Generator(dev).manual_seed(0), cfg, SINGLE_POD_PLAN)
    x = torch.randn((b, s, cfg.d_model), generator=torch.Generator(dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    weight_gb = sum(params[k].numel() * params[k].element_size()
                    for k in ("w1", "wg", "w2")) / 1e9
    t0 = time.perf_counter()
    route_trace(params, cfg, x, 16)
    t_route = time.perf_counter() - t0

    walls = {}
    real = {h: getattr(CommDSEProblem, h) for h in ("surrogate_batch", "verify_batch")}

    def timed(hook):
        def wrapped(self, cands):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real[hook](self, cands)
            torch.cuda.synchronize()
            walls[hook] = walls.get(hook, 0.0) + time.perf_counter() - t
            return out
        return wrapped
    before = _read_counters()
    try:
        for hook in real:
            setattr(CommDSEProblem, hook, timed(hook))
        t0 = time.perf_counter()
        result, problem = autotune_moe(params, cfg, SINGLE_POD_PLAN, None, x,
                                       model_tp=16)
        torch.cuda.synchronize()
        t_tune = time.perf_counter() - t0
    finally:
        for hook, fn in real.items():
            setattr(CommDSEProblem, hook, fn)
    after = _read_counters()
    launches = {k: after[k] - before[k] for k in ("quantize", "dequantize")}

    tokens = b * s
    errors = []
    if int(problem.loads.sum()) != tokens * cfg.moe_topk:
        errors.append(f"route_trace loads sum {int(problem.loads.sum())} != "
                      f"{tokens * cfg.moe_topk}")
    if result.best is None or result.best_verify.drop_rate > 2e-2:
        errors.append(f"no champion within the 2e-2 drop SLA: {result.best}")
    for _, v, _, _ in result.evaluated:
        if int(v.meta["expert_load"].sum()) != tokens * cfg.moe_topk:
            errors.append("a verified candidate's expert loads do not sum "
                          "to tokens x k")

    # the int8 payload against bf16 at the champion's capacity and schedule;
    # one layer call each, timed, and the expert FFN's rate in it
    best = result.best
    cap = max(int(math.ceil(tokens * cfg.moe_topk / cfg.moe_experts
                            * best.capacity_factor)), 1)
    ffn_flops = 6 * cfg.moe_experts * cap * cfg.d_model * cfg.d_ff
    ys, layer_s = {}, {}
    for payload in ("bf16", "int8"):
        opts = dataclasses.replace(best, payload=payload).moe_options(cfg.router)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ys[payload], _ = apply_moe(params, cfg, SINGLE_POD_PLAN, None, x, opts)
        torch.cuda.synchronize()
        layer_s[payload] = time.perf_counter() - t0
    yb, yi = ys["bf16"].double(), ys["int8"].double()
    rel = float(torch.linalg.vector_norm(yi - yb) / torch.linalg.vector_norm(yb))
    finite = bool(torch.isfinite(yi).all() and torch.isfinite(yb).all())
    if not finite:
        errors.append("the layer output is not finite")
    rows = dispatch_rows(tokens, cfg.moe_topk, cfg.moe_experts,
                         best.capacity_factor, best.a2a_chunks)
    buf = torch.randn((rows, cfg.d_model), device=dev).to(torch.bfloat16)
    q, sc = qk.quantize(buf)
    q_ms = cuda_ms(lambda: qk.quantize(buf), reps=20)
    d_ms = cuda_ms(lambda: qk.dequantize(q, sc, torch.bfloat16), reps=20)
    rec = {"run": f"autotune_moe {SCALE_ARCH} layer", "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "experts": cfg.moe_experts, "top_k": cfg.moe_topk,
           "tokens": tokens, "model_tp": 16, "expert_weights_gb": weight_gb,
           "best": best.short(), "best_drop_rate": result.best_verify.drop_rate,
           "best_p99_latency_ns": result.best_verify.p99_latency_ns,
           "verified": len(result.evaluated),
           "init_s": t_init, "route_trace_s": t_route,
           "autotune_moe_s": t_tune,
           "stage2_s": walls.get("surrogate_batch", 0.0),
           "stage4_s": walls.get("verify_batch", 0.0),
           "launches": launches,
           "dispatch_rows_per_chunk": rows,
           "quantize_bf16_ms_at_this_shape": q_ms,
           "dequantize_bf16_ms_at_this_shape": d_ms,
           "int8_vs_bf16_rel_err": rel,
           "champion_layer_s": layer_s, "champion_capacity": cap,
           "champion_ffn_tflop": ffn_flops / 1e12,
           "champion_ffn_tflops_per_s_bf16": ffn_flops / layer_s["bf16"] / 1e12,
           "peak_device_mb": torch.cuda.max_memory_allocated(dev) / 2**20,
           "errors": errors}
    stats["scale"].append(rec)
    say("scale", **rec)
    del params, x, ys, buf, q, sc, problem, result
    torch.cuda.empty_cache()
    if errors:
        raise AssertionError(f"scale moe: {errors}")
    if not (launches["quantize"] > 0 and launches["dequantize"] > 0):
        raise AssertionError(f"autotune_moe ran no int8 candidate: {launches}")


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
    host_profile_calibration(dev, stats)


def host_profile_calibration(dev, stats):
    """Where a calibration's host time goes: cProfile over one datacenter
    calibration (32 ports, 38,400 packets), its champion's family."""
    import cProfile
    import pstats
    import torch
    from repro_torch.api import build_bound, registry
    from repro_torch.core.archspec import (ForwardTableKind, SchedulerKind,
                                           SwitchArch, VOQKind)
    from repro_torch.sim import backannotate
    from repro_torch.sim.resources import synthesize

    bound = build_bound(registry["datacenter"])
    arch = SwitchArch(32, 1024, ForwardTableKind.FULL_LOOKUP, VOQKind.NXN,
                      SchedulerKind.ISLIP, voq_depth=36, addr_bits=5)
    fclk = synthesize(arch, bound).fmax_mhz * 1e6

    def fn():
        backannotate._ETA_CACHE.clear()
        backannotate._measured_eta(arch, bound, fclk, device=dev)
        torch.cuda.synchronize()
    fn()                                   # warm: the kernels are loaded
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    prof.disable()
    wall = time.perf_counter() - t0
    st = pstats.Stats(prof)
    rows = [(f"{os.path.basename(path)}:{line}:{name}", cc, tt, ct)
            for (path, line, name), (cc, _nc, tt, ct, _) in st.stats.items()]
    fmt = lambda rs: [[name, cc, round(tt, 6), round(ct, 6)]  # noqa: E731
                      for name, cc, tt, ct in rs]
    rec = {"run": f"host calibration datacenter {arch.short()}",
           "wall_profiled_s": wall, "total_tt_s": st.total_tt,
           "top_tottime_s": fmt(sorted(rows, key=lambda r: -r[2])[:10]),
           "top_cumtime_s": fmt(sorted(rows, key=lambda r: -r[3])[:10])}
    stats.setdefault("profile", []).append(rec)
    say("profile", **rec)


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
    # no longer on a main path (its rounds run inside switch_loop, from
    # csrc/islip_match.cuh): one 8-port switch, 2 rounds
    "islip_schedule": {"source": "src/repro_torch/csrc/islip.cu",
                       "replaces": "src/repro/kernels/islip/kernel.py:73",
                       "main": ("islip_n8_it2", "B1")},
    # one launch per simulation: hft's rung-4 champion at full length
    "switch_loop": {"source": "src/repro_torch/csrc/switch_loop.cu",
                    "replaces": "src/repro/switch/switch.py:214 (lax.scan) and "
                                "src/repro/kernels/islip/kernel.py:73",
                    "main": ("hft_rung4_champion", None)},
    # no longer on a main path (the switch parses at ingress inside
    # switch_loop): hft's protocol at its calibration trace's 9,600 headers
    "parse_headers": {"source": "src/repro_torch/csrc/parser.cu",
                      "replaces": "src/repro/kernels/parser/kernel.py:45",
                      "main": ("parser_hft", "B9600")},
    # moe_dispatch's champion: one bf16 chunk of its dispatch buffer
    "quantize": {"source": "src/repro_torch/csrc/quant_pack.cu",
                 "replaces": "src/repro/kernels/quant_pack/kernel.py:45",
                 "main": ("quantize_bf16", "moe_dispatch")},
    "dequantize": {"source": "src/repro_torch/csrc/quant_pack.cu",
                   "replaces": "src/repro/kernels/quant_pack/kernel.py:69",
                   "main": ("dequantize_bf16", "moe_dispatch")},
    # llama3.2-1b's prefill of 4 x 8,192 tokens: one call per layer
    "flash_attention": {"source": "src/repro_torch/csrc/flash_attention.cu",
                        "replaces": "src/repro/kernels/flash_attention/kernel.py:63",
                        "main": ("bf16_causal", "llama_prefill")},
    # mamba2-780m's prefill of 4 x 8,192 tokens (x, B and C in bfloat16):
    # one call (three launches) per layer
    "ssd_scan": {"source": "src/repro_torch/csrc/ssd.cu",
                 "replaces": "src/repro/kernels/ssd/kernel.py:65",
                 "main": ("x_bf16_bc_bf16", "mamba_prefill")},
    # stage 4 with use_kernel="off" (the goldens' off runs): hft's shape, a
    # batch of mixed sized depths; the reference runs it as a lax.scan (no
    # Pallas counterpart)
    "ring_scan": {"source": "src/repro_torch/csrc/ring_scan.cu",
                  "replaces": "src/repro/sim/batched_netsim.py:75 (lax.scan)",
                  "main": ("ring_hft_mixed", "hft")},
}


def kernels_line(stats):
    """One entry per kernel: its main-path form and shape, the largest
    disagreement over every form and shape, and its path's launches."""
    out = []
    for name, meta in KERNELS.items():
        forms = [r for r in stats["forms"] if r["kernel"] == name]
        form, shape = meta["main"]
        main = next((r for r in forms if r["form"] == form
                     and shape in (None, r["shape"])), {})
        out.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": stats["launches"].get(name, 0),
            "max_abs_err": max((r["max_abs_err"] for r in forms), default=None),
            "ms": main.get("ms"), "plain_ms": main.get("plain_ms"),
            "bound_ms": main.get("bound_ms"), "bound_by": main.get("bound_by"),
            "library_ms": main.get("library_ms"),
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
    build = {"seconds": time.perf_counter() - t0, "build_dir": str(BUILD_DIR),
             "ptxas": regs}
    say("build", **build)

    stats = {"forms": [], "flash_seeds": [], "scale": [], "switch": [], "comm": [],
             "serving": [], "launches": {}}
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
    out = os.path.join(ROOT, "build")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_smoke_stats.json"), "w") as f:
        json.dump({"device": smi, "build": build, "failed": failed, **stats}, f,
                  indent=1, default=str)
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
