"""Time the crossbar scan and the netsim replay (and the attention kernel at
llama3.2-1b's prefill, the header parser and the cycle-level switch's
loop) from one tree of the repo, so that two trees can be compared on one
card; ``--check`` also holds every scan form against its plain version,
bitwise, over a matrix of shapes.

    python3 tests/torch_scan_ab.py                   # this tree's package
    python3 tests/torch_scan_ab.py --src OTHER/src   # another tree's
    python3 tests/torch_scan_ab.py --check           # + the bitwise matrix
    python3 tests/torch_scan_ab.py --parts parser,switch   # a subset
    python3 tests/torch_scan_ab.py --parts parser_plans    # the parser's tiles
    python3 tests/torch_scan_ab.py --parts ring            # the ring-scan engine
    python3 tests/torch_scan_ab.py --parts alone           # launch_ms vs torch.profiler
    python3 tests/torch_scan_ab.py --parts flash_bwd       # the attention gradient
    python3 tests/torch_scan_ab.py --parts ssd_bwd         # the SSD gradient
    python3 tests/torch_scan_ab.py --parts hooks           # the in-switch all-reduce

Run it from each tree in turns (A, B, B, A) in one run on the card.  It
measures (ms per call, CUDA events over back-to-back calls after a warm-up)
the five scan forms (xbar absolute float64 and slack float32; netsim
ungated and gated absolute float64, gated slack float32) at three of
``chip_smoke.py``'s kernels-phase shapes (``SCAN_SHAPES``): hft (B 48,
m 3,707, 8 ports), space480 (B 480) and datacenter (B 8, m 530, 32 ports),
on timelines from ``chip_smoke.timeline``, and ``flash_attention`` and SDPA
at llama3.2-1b's prefill.  Each scan form also gets ``kernel_ms``, the
device time of its kernel alone from CUDA events around replays of a CUDA
graph of one call (``chip_smoke.launch_ms``; the wrapper's ``ms`` includes
what the host does between launches, its port-id check among it).  The
graph needs a tree whose wrappers skip their host reads while the stream
is capturing (``kernels/build.py``'s ``capturing``); ``--src`` naming an
older tree times its calls (``ms``) but not its kernels alone.  The matrix: n_ports 4, 8, 32, 40 and 300; m 1, 31, 33, 530 and
3,707; B 7 (not a multiple of the rows a block holds), its first row
admitting no event and its second every event.  ``parser``: the header
parser's forms of ``chip_smoke.py`` (the hft, datacenter and
Ethernet/IPv4/UDP protocols, every field, at 9,600 and 1,048,576 headers;
``parse_headers`` and ``parse_kernel`` alone, and bitwise against the plain
version).  ``switch``: ``switch_loop`` on hft's rung-4 champion at full
length (97,720 cycles), a call and the kernel alone, in µs a cycle (not
held to the eager loop here, which takes minutes on the card); it
takes whichever inputs the tree's ``switch_loop`` takes (parsed keys, or
the header words and the keys' slices).  ``parser_plans`` (this tree only,
not in the default parts): the parser kernel alone at hft's and
Ethernet/IPv4/UDP's 9,600 and 1,048,576 headers under each tile size and
blocks per SM of ``PARSER_PLANS``, the sweep behind ``kernels/parser``'s
``TILE_WORDS`` and ``BLOCKS_PER_SM``.  ``ring`` (not in the default
parts): the ring-scan stage-4 kernel at ``chip_smoke.py``'s
``RING_SHAPES`` in their mixed-depth form, the kernel alone over 3 calls
after half a second idle (``kernel_ms_cold``), over 3 calls just after
~0.2 s of a busy one-thread kernel (``kernel_ms_warm``) and over 300
calls (``kernel_ms_300``), and a call (``ms``): a kernel this short is
timed on a card whose clocks may not have ramped up.  ``alone`` (not in
the default parts): each kernel alone at one form (xbar and netsim at hft,
the parser at hft's and Ethernet/IPv4/UDP's 9,600 and 1,048,576 headers,
``switch_loop`` at hft's rung-4 champion, the ring scan at hft) by
``chip_smoke.launch_ms`` and by a ``torch.profiler`` window of the same
calls in the same process, to hold the one against the other.
``flash_bwd`` (not in the default parts): the attention gradient at
``chip_smoke.py``'s bfloat16 ``FLASH_BWD_FORMS`` (llama3.2-1b's training
shape first), a call (``ms``) and the kernel alone (``kernel_ms``), and,
where the tree has ``kernel.bwd_passes``, each of its three launches
alone (``pre_ms``, ``kv_ms``, ``q_ms``); and the forward kernel alone at
llama3.2-1b's prefill without and, where the tree takes it, with the
log-sum-exp buffer (``fwd_kernel_ms``, ``fwd_lse_kernel_ms``).
``ssd_bwd`` (not in the default parts): the SSD gradient at
``chip_smoke.py``'s ``SSD_BWD_FORMS`` with x, B and C in bfloat16
(mamba2-780m's training shape first), a call (``ms``), the kernel alone
(``kernel_ms``), each launch alone by ``torch.profiler`` over the same
calls (``profiler_ms``: device ms a call by kernel name) and, where the
tree has ``kernel.bwd_passes``, by ``launch_ms`` (``<launch>_ms``, the
names ``kernel.plan_bwd`` gives), and ``plan_bwd``'s path where the tree
has it.  ``hooks`` (this tree only, not in the default parts): the
in-switch all-reduce example's two switches on its full trace
(``examples/inswitch_allreduce_torch.py``, 515,653 cycles): each
``simulate`` (wall), the hooked switch's ingress and egress passes alone
and the hooks' host time inside its ``simulate``, the same host loop with a
hook that returns its inputs (``identity_hook_host_s``: the loop's own
cost), and the baseline's fused loop alone.

Needs a CUDA card; prints the card's name and power limit, then one JSON
line per result.  Exits 1 if a form of the matrix disagrees.
"""
import argparse
import dataclasses
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
    """Device time per call of the kernels alone: CUDA events around
    replays of a CUDA graph of one call (``chip_smoke.launch_ms``)."""
    return CS.launch_ms(fn, reps)


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


def time_parser(torch, dev, reps):
    from repro_torch.kernels.parser import parse_headers, parse_ref
    for name in CS.PARSER_PROTOCOLS:
        proto = CS.parser_protocol(name)
        fields = [f.name for f in proto.fields]
        for b in CS.PARSER_BATCHES:
            words = CS.parser_words(proto, b, dev)
            kern = lambda: parse_headers(proto, fields, words)    # noqa: E731
            equal = bool(torch.equal(kern(), parse_ref(proto, fields, words)))
            w = words.shape[1]
            bound_ms = b * (w + len(fields)) * 4 / CS.HBM_BYTES_PER_S * 1e3
            k_ms = CS.launch_ms(kern, reps)
            print(json.dumps({"form": f"parser_{name}", "B": b, "words": w,
                              "fields": len(fields), "ms": cuda_ms(torch, kern, reps),
                              "kernel_ms": k_ms, "bound_ms": bound_ms,
                              "bound_share": bound_ms / k_ms, "bitwise_equal": equal}),
                  flush=True)


#: (TILE_WORDS, BLOCKS_PER_SM) of the parser's plan sweep
PARSER_PLANS = [(tw, bps) for tw in (1536, 3072, 6144, 12288) for bps in (1, 2, 4, 8)]


def time_parser_plans(torch, dev, reps):
    from repro_torch.kernels.parser import parse_headers, parse_ref
    from repro_torch.kernels.parser import kernel as pk
    forms = []
    for name in ("hft", "ethernet_ipv4_udp"):
        proto = CS.parser_protocol(name)
        fields = [f.name for f in proto.fields]
        for b in CS.PARSER_BATCHES:
            forms.append((f"{name}_B{b}", proto, fields, CS.parser_words(proto, b, dev)))
    chosen = pk.TILE_WORDS, pk.BLOCKS_PER_SM
    try:
        for pk.TILE_WORDS, pk.BLOCKS_PER_SM in PARSER_PLANS:
            pk.plan.cache_clear()
            rec = {"form": "parser_plan", "tile_words": pk.TILE_WORDS,
                   "blocks_per_sm": pk.BLOCKS_PER_SM}
            for key, proto, fields, words in forms:
                kern = lambda: parse_headers(proto, fields, words)   # noqa: E731
                if not torch.equal(kern(), parse_ref(proto, fields, words)):
                    raise AssertionError(f"parser plan {rec} disagrees at {key}")
                rec[f"{key}_kernel_ms"] = CS.launch_ms(kern, reps)
            print(json.dumps(rec), flush=True)
    finally:
        pk.TILE_WORDS, pk.BLOCKS_PER_SM = chosen
        pk.plan.cache_clear()


def time_switch(torch, dev, reps):
    import inspect
    from repro_torch.kernels.switch_loop import ops as loop_ops
    from repro_torch.kernels.parser import parse_headers
    from repro_torch.switch.switch import prepare_cycle_inputs
    arch, bound, trace, fclk, cycles = CS.switch_loop_forms(dev)["hft_rung4_champion"]
    prep = prepare_cycle_inputs(arch, bound, trace, fclk, max_cycles=cycles)
    arr = torch.from_numpy(prep["arr_pid"]).to(dev)
    words = torch.from_numpy(prep["header_words"]).to(dev)
    sizes = torch.from_numpy(prep["size_flits"]).to(dev)
    fields = [bound.semantics["routing_key"], bound.semantics["src_key"]]
    if len(inspect.signature(loop_ops.switch_loop).parameters) == 5:
        from repro_torch.kernels.parser import slices
        args = (arch, arr, words, sizes, slices(bound.protocol, fields).baked)
    else:                                 # parsed keys, before the parse moved in
        args = (arch, arr, parse_headers(bound.protocol, fields, words), sizes)
    kern = lambda: loop_ops.switch_loop(*args)    # noqa: E731
    got = kern()
    t = arr.shape[0]
    ms = cuda_ms(torch, kern, reps)
    k_ms = CS.launch_ms(kern, reps)
    # the eager loop takes minutes here; chip_smoke.py holds the kernel to it
    print(json.dumps({"form": "switch_loop_hft_rung4_champion", "cycles": t, "ms": ms,
                      "kernel_ms": k_ms, "us_per_cycle": ms * 1e3 / t,
                      "kernel_us_per_cycle": k_ms * 1e3 / t,
                      "delivered": int(got.delivered)}), flush=True)


def time_hooks(torch, dev, reps):
    import time
    from repro_torch.core import bind, compressed_protocol
    from repro_torch.kernels.switch_loop import hooks
    from repro_torch.kernels.switch_loop import kernel as slk
    from repro_torch.kernels.switch_loop import ops as loop_ops
    from repro_torch.sim.resources import synthesize
    from repro_torch.switch.switch import simulate
    from repro_torch.traces import rl_allreduce
    (_, base), (_, hooked) = CS._example("inswitch_allreduce_torch").architectures(8)
    bound = bind(compressed_protocol(addr_bits=4, length_bits=12), flit_bits=1024)
    fclk = synthesize(hooked, bound).fmax_mhz * 1e6
    trace = rl_allreduce(seed=0, n_ports=8)
    real, seen = hooks.run_hooks, {}

    def timed(arch, arr_pid, out):
        t0 = time.perf_counter()
        seen["hooked"] = real(arch, arr_pid, out)
        seen["host_s"] = time.perf_counter() - t0
        return seen["hooked"]
    rec = {"form": "inswitch_allreduce_full"}
    hooks.run_hooks = timed
    try:
        for name, arch in (("baseline", base), ("hooked", hooked)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = simulate(arch, bound, trace, fclk_hz=fclk, device=dev)
            rec[f"{name}_simulate_s"] = time.perf_counter() - t0
            rec[f"{name}_delivered"] = res.delivered_copies
    finally:
        hooks.run_hooks = real
    arr, words, sizes, keys = CS._switch_form(hooked, bound, trace, fclk, None, dev)
    out_d, valid_d = loop_ops.egress_inputs(*seen["hooked"], dev)
    t = arr.shape[0]
    # the host loop's own cost: run_hooks on the same cycles with a hook
    # that returns its inputs
    spec = hooked.custom_kernels[0]
    ident = dataclasses.replace(hooked, custom_kernels=(dataclasses.replace(
        spec, fn=lambda st, p, o, v, c: (st, o, v)),))
    out_c = slk.switch_ingress_launch(hooked, arr, words, keys).cpu()
    t0 = time.perf_counter()
    hooks.run_hooks(ident, arr.cpu(), out_c)
    ident_s = time.perf_counter() - t0
    rec.update(cycles=t, hooks_host_s=seen["host_s"],
               hooks_host_us_per_cycle=seen["host_s"] * 1e6 / t,
               identity_hook_host_s=ident_s,
               identity_hook_host_us_per_cycle=ident_s * 1e6 / t,
               ingress_ms=CS.launch_ms(lambda: slk.switch_ingress_launch(
                   hooked, arr, words, keys), reps),
               egress_ms=CS.launch_ms(lambda: slk.switch_egress_launch(
                   hooked, arr, out_d, valid_d, sizes), reps),
               fused_ms=CS.launch_ms(lambda: slk.switch_loop_launch(
                   base, arr, words, sizes, keys), reps))
    print(json.dumps(rec), flush=True)


def time_ring(torch, dev, reps):
    import time
    from repro_torch.kernels.ring_scan import kernel as rk
    from repro_torch.kernels.ring_scan import ring_scan
    io = torch.tensor([0.0, 1e-8, 0.0, 2e-8, 3e-8, 1e-8], dtype=torch.float64, device=dev)
    ring = torch.zeros(64, dtype=torch.float64, device=dev)

    def burn():                      # ~0.2 s of one busy thread
        rk.chain_step(io, ring, 1 << 21, mod=8, depth=8)
        torch.cuda.synchronize()
    for shape, (n, m, mixed) in CS.RING_SHAPES.items():
        t, src, dst, svc, pipe, _ = CS.timeline(np.random.default_rng(n), m, n,
                                                len(mixed), f64=True)
        depth = np.asarray(mixed, np.int32)
        mod = np.minimum(np.maximum(depth, 1), m).astype(np.int32)
        d_max = 1 << int(int(mod.max()) - 1).bit_length()
        args = [torch.tensor(a, device=dev) for a in (t, src, dst, svc, pipe, depth, mod)]
        kern = lambda: ring_scan(*args, n_ports=n, d_max=d_max)   # noqa: E731
        kern()
        torch.cuda.synchronize()
        time.sleep(0.5)
        cold = kernel_ms(torch, kern, 3)
        burn()
        warm = kernel_ms(torch, kern, 3)
        print(json.dumps({"form": f"ring_{shape}_mixed", "B": len(mixed), "m": m,
                          "n_ports": n, "kernel_ms_cold": cold, "kernel_ms_warm": warm,
                          "kernel_ms_300": kernel_ms(torch, kern, 300),
                          "ms": cuda_ms(torch, kern, reps)}), flush=True)


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


def time_flash_bwd(torch, dev, reps):
    from repro_torch.kernels.flash_attention import kernel as fk
    b, hq, hkv, s, d = 4, 32, 8, 8192, 64            # chip_smoke.py's llama_prefill
    q, k, v = CS._attn_inputs(b, hq, hkv, s, d, dev, torch.bfloat16, seed=s + hq)
    rec = {"form": "flash_llama_prefill",
           "fwd_kernel_ms": CS.launch_ms(lambda: fk.flash_attention(q, k, v, causal=True),
                                         reps)}
    if hasattr(fk, "plan_bwd"):
        lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
        rec["fwd_lse_kernel_ms"] = CS.launch_ms(
            lambda: fk.flash_attention(q, k, v, causal=True, lse=lse), reps)
    print(json.dumps(rec), flush=True)
    del q, k, v
    for form, shape, b, hq, hkv, s, d, window, dt in CS.FLASH_BWD_FORMS:
        if dt != "bf16":
            continue
        q, k, v = CS._attn_inputs(b, hq, hkv, s, d, dev, torch.bfloat16, seed=s + hq + 1)
        do = torch.randn(q.shape, device=dev,
                         generator=torch.Generator(dev).manual_seed(s)).bfloat16()
        kw = dict(causal=True, window=window)
        rec = {"form": f"flash_bwd_{form}", "shape": shape}
        if hasattr(fk, "bwd_passes"):
            lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
            o = fk.flash_attention(q, k, v, lse=lse, **kw)
            kw["lse"] = lse
            scratch = torch.empty((2, b * hq * fk.plan_bwd(q.dtype, d, s)["pitch"]),
                                  dtype=torch.float32, device=dev)
            for name, passes in (("pre", 1), ("kv", 2), ("q", 4)):
                rec[f"{name}_ms"] = CS.launch_ms(lambda p=passes: fk.bwd_passes(
                    q, k, v, o, do, passes=p, scratch=scratch, **kw), reps)
        else:
            o = fk.flash_attention(q, k, v, **kw)
        call = lambda: fk.flash_attention_bwd(q, k, v, o, do, **kw)  # noqa: E731
        rec.update({"ms": cuda_ms(torch, call, reps), "kernel_ms": CS.launch_ms(call, reps)})
        print(json.dumps(rec), flush=True)
        del q, k, v, do, o
        torch.cuda.empty_cache()


def time_ssd_bwd(torch, dev, reps):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd import kernel as sk
    for form, shape, heads, bh, s, p, n, _, xt, bct in CS.SSD_BWD_FORMS:
        if (xt, bct) != ("bf16", "bf16"):
            continue
        x, dt, a, b, c = CS._ssd_inputs(bh, heads, s, p, n, dev, seed=s + 7)
        x, b, c = x.bfloat16(), b.bfloat16(), c.bfloat16()
        dy = (torch.randn((bh, s, p), device=dev,
                          generator=torch.Generator(dev).manual_seed(s)) * 0.1).bfloat16()
        call = lambda: sk.ssd_scan_bwd(x, dt, a, b, c, dy)  # noqa: E731
        rec = {"form": f"ssd_bwd_{form}", "shape": shape,
               "ms": cuda_ms(torch, call, reps), "kernel_ms": CS.launch_ms(call, reps)}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        rec["profiler_ms"] = {
            e.key: (getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0))
            / reps / 1e3 for e in prof.key_averages() if "ssd" in e.key}
        if hasattr(sk, "plan_bwd"):
            plan = sk.plan_bwd(x.dtype, b.dtype, p, n, s, bh=bh, groups=bh // heads)
            rec["path"] = plan["path"]
            scratch = torch.empty(sk.bwd_scratch_floats(bh, s, p, n, x.dtype, b.dtype),
                                  dtype=torch.float32, device=dev)
            sk.bwd_passes(x, dt, a, b, c, dy, scratch=scratch)   # fills the scratch
            for i, name in enumerate(plan["launches"]):
                rec[f"{name}_ms"] = CS.launch_ms(lambda m=1 << i: sk.bwd_passes(
                    x, dt, a, b, c, dy, passes=m, scratch=scratch), reps)
            del scratch
        print(json.dumps(rec), flush=True)
        del x, dt, a, b, c, dy
        torch.cuda.empty_cache()


def profiler_ms(torch, fn, name, reps):
    """Device time per call of the kernels whose names hold ``name``, in one
    torch.profiler window, and the records it kept."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key]
    us = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
             for e in hits)
    return us / reps / 1e3, sum(e.count for e in hits)


def time_alone(torch, dev, reps):
    from repro_torch.kernels.parser import parse_headers
    from repro_torch.kernels.ring_scan import ring_scan
    from repro_torch.kernels.switch_loop import kernel as slk
    b, m, n = SHAPES["hft"]
    arrays = arrays_of(0, m, n, b)
    calls = [(f"{form}_hft", "port_scan", form_calls(torch, dev, form, arrays, n)[0], reps)
             for form in ("xbar_abs_f64", "netsim_ungated_abs_f64")]
    for name in ("hft", "ethernet_ipv4_udp"):
        proto = CS.parser_protocol(name)
        fields = [f.name for f in proto.fields]
        for rows in CS.PARSER_BATCHES:
            words = CS.parser_words(proto, rows, dev)
            calls.append((f"parser_{name}_B{rows}", "parse",
                          lambda p=proto, f=fields, w=words: parse_headers(p, f, w), reps))
    arch, bound, trace, fclk, cycles = CS.switch_loop_forms(dev)["hft_rung4_champion"]
    loop_args = CS._switch_form(arch, bound, trace, fclk, cycles, dev)
    calls.append(("switch_loop_hft_rung4_champion", "switch_loop",
                  lambda: slk.switch_loop_launch(arch, *loop_args), 3))
    n8, m8, mixed = CS.RING_SHAPES["hft"]
    t, src, dst, svc, pipe, _ = CS.timeline(np.random.default_rng(n8), m8, n8,
                                            len(mixed), f64=True)
    depth = np.asarray(mixed, np.int32)
    mod = np.minimum(np.maximum(depth, 1), m8).astype(np.int32)
    d_max = 1 << int(int(mod.max()) - 1).bit_length()
    ring_args = [torch.tensor(a, device=dev) for a in (t, src, dst, svc, pipe, depth, mod)]
    calls.append(("ring_hft_mixed", "ring_scan",
                  lambda: ring_scan(*ring_args, n_ports=n8, d_max=d_max), reps))
    for form, name, fn, r in calls:
        prof, records = profiler_ms(torch, fn, name, r)
        print(json.dumps({"form": form, "launch_ms": CS.launch_ms(fn, r),
                          "profiler_ms": prof, "profiler_records": records,
                          "calls": r}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(REPO, "src"),
                    help="the directory holding the repro_torch package to time")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parts", default="scans,flash,parser,switch",
                    help="comma-separated subset of scans, flash, parser, switch, "
                         "parser_plans, ring, alone, flash_bwd, ssd_bwd, hooks")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
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
    if "scans" in parts:
        time_scans(torch, dev, args.reps)
    if "flash" in parts:
        time_flash(torch, dev, args.reps)
    if "parser" in parts:
        time_parser(torch, dev, args.reps)
    if "switch" in parts:
        time_switch(torch, dev, 3)
    if "parser_plans" in parts:
        time_parser_plans(torch, dev, args.reps)
    if "ring" in parts:
        time_ring(torch, dev, args.reps)
    if "alone" in parts:
        time_alone(torch, dev, args.reps)
    if "flash_bwd" in parts:
        time_flash_bwd(torch, dev, args.reps)
    if "ssd_bwd" in parts:
        time_ssd_bwd(torch, dev, args.reps)
    if "hooks" in parts:
        time_hooks(torch, dev, 3)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
