"""The port's netsim family (``repro_torch.kernels.netsim``) and batched
stage-4 verifier (``repro_torch.sim.batched_netsim``) against the JAX package.

Contract: the plain PyTorch replays are bitwise equal to the JAX float64
oracles (the gated ``netsim_replay_abs_ref`` and round 1's
``_round1_body``) and to the float32 slack oracle and Pallas tile run in
interpret mode, for 8 and 32 ports; ``netsim_fixed_point`` returns the
reference's end times, admissions, convergence flags and round count; and
``run_netsim_batched`` on the CPU is bit-identical per candidate to the
reference's engines and to the serial ``run_netsim`` across the
hft/datacenter × NXN/SHARED × depth 2/8/64 matrix, the shared-cap incast,
degenerate depths and the empty trace.  The CUDA kernel runs only on a
card: the ``cuda``-marked tests skip here.
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

from jax.experimental import pallas as pl  # noqa: E402

# it also dropped pl.load / pl.store, which the reference's Pallas tiles use;
# in interpret mode they are plain ref indexing
if not hasattr(pl, "load"):
    pl.load = lambda ref, idx: ref[idx]
    pl.store = lambda ref, idx, val: ref.__setitem__(idx, val)

import math  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import (ArchRequest, ForwardTableKind, SchedulerKind,  # noqa: E402
                        SwitchArch, VOQKind, bind, compressed_protocol,
                        enumerate_candidates)
from repro.kernels import netsim as ref_kn  # noqa: E402
from repro.kernels.netsim.ops import _round1_body  # noqa: E402
from repro.sim import run_netsim as ref_run_netsim  # noqa: E402
from repro.sim import run_netsim_batched as ref_batched  # noqa: E402
from repro.sim import timeline as ref_tl  # noqa: E402
from repro.traces import datacenter, hft  # noqa: E402
from repro.traces.base import Trace as RefTrace  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.kernels import netsim as kn  # noqa: E402
from repro_torch.kernels.netsim import kernel as port_kernel  # noqa: E402
from repro_torch.kernels.netsim import ref as port_ref  # noqa: E402
from repro_torch.sim import run_netsim_batched  # noqa: E402

BOUND = bind(compressed_protocol(addr_bits=4, length_bits=6), flit_bits=256)


def _inputs(seed, m, b, n):
    """A sorted timeline with real contention, per-row pipes and ~85 %
    admissions."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(2e-8, m)
    gaps[0] = 0.0
    now = np.cumsum(gaps)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    svc = rng.uniform(1e-8, 8e-8, (b, m))
    pipe = rng.uniform(1e-8, 5e-8, b)
    admit = rng.random((b, m)) < 0.85
    return now, src, dst, svc, pipe, admit


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# plain replays vs the JAX oracles and the Pallas tile
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_ports", [8, 32])
def test_gated_replay_bitwise_vs_jax_f64(n_ports):
    now, src, dst, svc, pipe, admit = _inputs(0, 300, 6, n_ports)
    with jax.enable_x64(True):
        want = np.asarray(ref_kn.netsim_replay_abs_ref(
            jnp.asarray(now), jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(svc), jnp.asarray(pipe), jnp.asarray(admit),
            n_ports=n_ports))
    got = port_ref.netsim_replay_abs_ref(_t(now), _t(src), _t(dst), _t(svc),
                                         _t(pipe), _t(admit), n_ports=n_ports)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_ports", [8, 32])
def test_round1_bitwise_vs_jax_round1_body(n_ports):
    """Ungated replay plus the all-admitted fullness check, against the
    reference's fused round 1 on a real chain index (small depths so some
    rows do find a full queue)."""
    now, src, dst, svc, pipe, _ = _inputs(1, 400, 8, n_ports)
    depth = np.array([1, 2, 3, 4, 8, 64, 2, 1], np.int32)
    chain = kn.build_chain_index(src.astype(np.int64) * n_ports + dst)
    with jax.enable_x64(True):
        end_w, ok_w = _round1_body(
            jnp.asarray(now), jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(svc.T), jnp.asarray(pipe), jnp.asarray(depth),
            jnp.asarray(chain.perm, jnp.int32),
            jnp.asarray(chain.seg_start), jnp.asarray(chain.rank),
            n_ports=n_ports)
        end_w, ok_w = np.asarray(end_w), np.asarray(ok_w)
    end, ok = port_ref.round1_ref(
        _t(now), _t(src), _t(dst), _t(svc), _t(pipe), _t(depth),
        _t(chain.perm), _t(chain.seg_start), _t(chain.rank), n_ports=n_ports)
    np.testing.assert_array_equal(end.numpy(), end_w)
    np.testing.assert_array_equal(ok.numpy(), ok_w)
    assert not ok_w.all() and ok_w.any()          # both outcomes exercised


@pytest.mark.parametrize("n_ports", [8, 32])
def test_slack_replay_bitwise_vs_jax_oracle_and_pallas_tile(n_ports):
    now, src, dst, svc, pipe, admit = _inputs(2, 200, 10, n_ports)
    dnow = np.diff(now, prepend=0.0).astype(np.float32)
    svc32, pipe32 = svc.astype(np.float32), pipe.astype(np.float32)
    want = np.asarray(ref_kn.netsim_replay_slack_ref(
        jnp.asarray(dnow), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(svc32), jnp.asarray(pipe32), jnp.asarray(admit),
        n_ports=n_ports))
    tile = np.asarray(ref_kn.lean_replay(now, src, dst, svc, pipe, admit,
                                         n_ports=n_ports, use_pallas=True,
                                         interpret=True))
    got = port_ref.netsim_replay_slack_ref(
        _t(dnow), _t(src), _t(dst), _t(svc32), _t(pipe32), _t(admit),
        n_ports=n_ports)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tile)
    port = kn.lean_replay(_t(now), _t(src), _t(dst), _t(svc), _t(pipe),
                          _t(admit), n_ports=n_ports, precision="float32")
    np.testing.assert_array_equal(port.numpy(), tile)


def test_lean_replay_float64_matches_reference():
    now, src, dst, svc, pipe, admit = _inputs(3, 150, 5, 8)
    with jax.enable_x64(True):
        want = np.asarray(ref_kn.lean_replay(now, src, dst, svc, pipe, admit,
                                             n_ports=8))
    got = kn.lean_replay(_t(now), _t(src), _t(dst), _t(svc), _t(pipe),
                         _t(admit), n_ports=8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("workload", ["hft", "datacenter"])
def test_fixed_point_matches_reference(workload):
    """End, admit, converged and rounds equal the reference's on a real
    stage-4 timeline at binding depths (rows iterate past round 1)."""
    tr = (hft(seed=0) if workload == "hft"
          else datacenter(seed=0, n_ports=8, duration_s=400e-6, load=0.8))
    tl4 = ref_tl.stage4_timeline(tr, 8, BOUND.header_bytes, 0.0)
    m = tl4.now.size
    rng = np.random.default_rng(4)
    b = 6
    svc = rng.uniform(2e-8, 2e-7, (b, m))
    pipe = rng.uniform(1e-8, 5e-8, b)
    depth = np.array([1, 2, 3, 8, 64, 4], np.int64)
    src, dst = tl4.src_o.astype(np.int32), tl4.dst_o.astype(np.int32)
    with jax.enable_x64(True):
        want = ref_kn.netsim_fixed_point(tl4.now, src, dst, svc, pipe, depth,
                                         n_ports=8, chain=tl4.chain)
    chain = kn.ChainIndex(perm=tl4.chain.perm, inv=tl4.chain.inv,
                          seg_start=tl4.chain.seg_start, rank=tl4.chain.rank,
                          n_chains=tl4.chain.n_chains)
    got = kn.netsim_fixed_point(tl4.now, src, dst, svc, pipe, depth,
                                n_ports=8, chain=chain,
                                device=torch.device("cpu"))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3] and want[3] > 1


def test_segmented_passes_match_reference_and_serial_counts():
    """The chain index and segmented admission are the reference's copies;
    segmented occupancy (an exact per-chain search in the port) equals the
    reference's flat-key pass here and the serial per-queue count."""
    from repro_torch.kernels.xbar.ref import xbar_contend_abs_ref
    now, src, dst, svc, pipe, admit = _inputs(5, 500, 4, 8)
    qid = src.astype(np.int64) * 8 + dst
    c_ref, c_port = ref_kn.build_chain_index(qid), kn.build_chain_index(qid)
    for f in ("perm", "inv", "seg_start", "rank"):
        np.testing.assert_array_equal(getattr(c_port, f), getattr(c_ref, f))
    end = now[None, :] + svc * 20
    depth = np.array([1, 2, 4, 8], np.int32)
    np.testing.assert_array_equal(
        kn.segmented_admission(end, admit, now, depth, c_port),
        ref_kn.segmented_admission(end, admit, now, depth, c_ref))
    # FIFO departures per chain, as the crossbar produces them
    dep = xbar_contend_abs_ref(_t(now), _t(src), _t(dst), _t(svc),
                               n_ports=8).numpy()
    got = kn.segmented_occupancy(now, dep, c_port)
    np.testing.assert_array_equal(got,
                                  ref_kn.segmented_occupancy(now, dep, c_ref))
    serial = np.zeros_like(got)
    for q in np.unique(qid):
        sel = np.nonzero(qid == q)[0]
        for b in range(dep.shape[0]):
            serial[b, sel] = np.arange(sel.size) - np.searchsorted(
                dep[b, sel], now[sel], side="right")
    np.testing.assert_array_equal(got, serial)


def test_segmented_occupancy_stays_exact_on_a_long_capture():
    """On a 37k-event hft capture at B = 48 the reference's flat float key
    miscounts some arrivals; the port's per-chain search keeps the serial
    per-queue counts exactly (why the port does not copy that pass)."""
    from repro_torch.kernels.xbar.ref import xbar_contend_abs_ref
    from repro_torch.sim.timeline import stage2_timeline
    tl = stage2_timeline(convert.from_reference(hft(seed=0,
                                                    duration_s=0.004)), 8)
    rng = np.random.default_rng(7)
    svc = rng.uniform(5e-9, 6e-8, (6, tl.t.size))
    dep6 = xbar_contend_abs_ref(_t(tl.t), _t(tl.src), _t(tl.dst), _t(svc),
                                n_ports=8).numpy()
    serial = np.zeros(dep6.shape, np.int64)
    for q in np.unique(tl.qid):
        sel = np.nonzero(tl.qid == q)[0]
        for b in range(6):
            serial[b, sel] = np.arange(sel.size) - np.searchsorted(
                dep6[b, sel], tl.t[sel], side="right")
    dep, serial = np.tile(dep6, (8, 1)), np.tile(serial, (8, 1))
    np.testing.assert_array_equal(
        kn.segmented_occupancy(tl.t, dep, tl.chain), serial)
    ref = ref_kn.segmented_occupancy(tl.t, dep,
                                     ref_kn.build_chain_index(tl.qid))
    assert (ref != serial).any()


# --------------------------------------------------------------------------
# run_netsim_batched: the reference's parity matrix and edges
# --------------------------------------------------------------------------

def _traces():
    return {
        "hft": hft(seed=0),
        "datacenter": datacenter(seed=0, n_ports=8, duration_s=400e-6,
                                 load=0.8),
    }


def _assert_identical(got, want, *, same_fallback=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.drop_rate == w.drop_rate
        assert g.p99_latency_ns == w.p99_latency_ns or (
            math.isinf(g.p99_latency_ns) and math.isinf(w.p99_latency_ns))
        assert g.mean_latency_ns == w.mean_latency_ns or (
            math.isinf(g.mean_latency_ns) and math.isinf(w.mean_latency_ns))
        assert g.throughput_gbps == w.throughput_gbps
        assert g.meta["delivered"] == w.meta["delivered"]
        if same_fallback:
            assert g.meta.get("fallback") == w.meta.get("fallback")
        np.testing.assert_array_equal(g.meta["latency_ns"], w.meta["latency_ns"])


@pytest.mark.parametrize("voq", ["nxn", "shared"])
@pytest.mark.parametrize("workload", ["hft", "datacenter"])
def test_stage4_parity_matrix(workload, voq):
    """hft/datacenter x NXN/SHARED x depths 2/8/64 against both reference
    engines (segmented kernel and ring scan); the small depths drop."""
    tr = _traces()[workload]
    kind = VOQKind.NXN if voq == "nxn" else VOQKind.SHARED
    base = [a for a in enumerate_candidates(ArchRequest(n_ports=8, addr_bits=4))
            if a.voq is kind]
    cands = [a.with_depth(d) for a in base[:6] for d in (2, 8, 64)]
    want_k = ref_batched(cands, BOUND, tr, back_annotation=False,
                         use_kernel=True)
    want_o = ref_batched(cands, BOUND, tr, back_annotation=False,
                         use_kernel=False)
    got = run_netsim_batched(convert.from_reference(cands),
                             convert.from_reference(BOUND),
                             convert.from_reference(tr),
                             back_annotation=False, device="cpu")
    assert any(v.drop_rate > 0 for v in want_o)
    _assert_identical(got, want_k)
    _assert_identical(got, want_o)


def test_shared_cap_incast_takes_flagged_fallback():
    n, per_src = 8, 120
    rng = np.random.default_rng(0)
    times = np.concatenate([np.arange(per_src) * 2.2e-7 + s * 1e-9
                            for s in range(n)])
    srcs = np.concatenate([np.full(per_src, s) for s in range(n)])
    dsts = np.concatenate([rng.integers(0, 4, per_src) for _ in range(n)])
    tr = RefTrace("incast4", times, srcs, dsts, np.full(n * per_src, 200), n,
                  link_gbps=10.0)
    cands = [SwitchArch(n_ports=8, bus_bits=bw,
                        fwd=ForwardTableKind.FULL_LOOKUP, voq=voq,
                        sched=SchedulerKind.RR, voq_depth=d, addr_bits=4)
             for bw in (128, 512)
             for voq in (VOQKind.SHARED, VOQKind.NXN) for d in (8, 16)]
    want = ref_batched(cands, BOUND, tr, back_annotation=False,
                       use_kernel=True)
    got = run_netsim_batched(convert.from_reference(cands),
                             convert.from_reference(BOUND),
                             convert.from_reference(tr),
                             back_annotation=False, device="cpu")
    assert any(v.meta.get("shared_cap_fallback") for v in got)
    _assert_identical(got, want)


def test_degenerate_depth_and_serial_oracle():
    tr = hft(seed=0).head(64)
    base = enumerate_candidates(ArchRequest(n_ports=8, addr_bits=4))
    cands = [base[0].with_depth(0), base[1].with_depth(8), base[2].with_depth(2)]
    got = run_netsim_batched(convert.from_reference(cands),
                             convert.from_reference(BOUND),
                             convert.from_reference(tr),
                             back_annotation=False, device="cpu")
    assert got[0].meta["fallback"] == "degenerate_depth"
    assert got[0].drop_rate == 1.0
    assert "fallback" not in got[1].meta
    _assert_identical(got, ref_batched(cands, BOUND, tr, back_annotation=False,
                                       use_kernel=True))
    _assert_identical(got, [ref_run_netsim(a, BOUND, tr, back_annotation=False)
                            for a in cands], same_fallback=False)


def test_empty_trace():
    from repro_torch.traces.base import Trace
    empty = Trace("empty", np.zeros(0), np.zeros(0, np.int32),
                  np.zeros(0, np.int32), np.zeros(0, np.int64), 8)
    cands = convert.from_reference(
        [a.with_depth(8) for a in
         enumerate_candidates(ArchRequest(n_ports=8, addr_bits=4))[:3]])
    got = run_netsim_batched(cands, convert.from_reference(BOUND), empty,
                             back_annotation=False, device="cpu")
    assert len(got) == 3
    for v in got:
        assert v.drop_rate == 0.0 and math.isinf(v.p99_latency_ns)


def test_ring_scan_engine_is_refused_and_cpu_never_launches():
    tr = convert.from_reference(hft(seed=0).head(128))
    cands = convert.from_reference(
        [a.with_depth(4) for a in
         enumerate_candidates(ArchRequest(n_ports=8, addr_bits=4))[:2]])
    with pytest.raises(NotImplementedError, match="ring-scan"):
        run_netsim_batched(cands, convert.from_reference(BOUND), tr,
                           back_annotation=False, use_kernel="off",
                           device="cpu")
    port_kernel.LAUNCHES = 0
    run_netsim_batched(cands, convert.from_reference(BOUND), tr,
                       back_annotation=False, device="cpu")
    assert port_kernel.LAUNCHES == 0


# --------------------------------------------------------------------------
# on the card only
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n_ports", [8, 32])
@pytest.mark.parametrize("form", ["ungated_f64", "gated_f64", "slack_f32"])
def test_cuda_kernel_bitwise_vs_plain(n_ports, form):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    now, src, dst, svc, pipe, admit = _inputs(6, 1000, 20, n_ports)
    dev = torch.device("cuda")
    absolute = form != "slack_f32"
    dtype = torch.float64 if absolute else torch.float32
    tnow = (now if absolute else np.diff(now, prepend=0.0))
    tn = torch.tensor(tnow, dtype=dtype, device=dev)
    s = torch.tensor(svc, dtype=dtype, device=dev)
    p = torch.tensor(pipe, dtype=dtype, device=dev)
    a = torch.tensor(admit, device=dev)
    si, di = torch.tensor(src, device=dev), torch.tensor(dst, device=dev)
    gated = form != "ungated_f64"
    got = port_kernel.netsim_replay(
        tn, si, di, s.t().contiguous(), p,
        a.t().to(torch.uint8).contiguous() if gated else None,
        n_ports=n_ports, absolute=absolute)
    if absolute:
        want = port_ref.netsim_replay_abs_ref(tn, si, di, s, p,
                                              a if gated else None,
                                              n_ports=n_ports)
    else:
        want = port_ref.netsim_replay_slack_ref(tn, si, di, s, p, a,
                                                n_ports=n_ports)
    assert torch.equal(got, want)
