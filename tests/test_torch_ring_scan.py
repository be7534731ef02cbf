"""The port's ring-scan stage-4 engine (``repro_torch.kernels.ring_scan``)
and ``run_netsim_batched(use_kernel=False)`` against the JAX package.

Contract: the plain PyTorch ring scan is bitwise equal (end times and
admission flags) to the reference's ``_verify_engine_impl`` (jitted, x64)
on the same numpy-seeded stage-4 inputs, over hft/datacenter x NXN/SHARED x
depths 1/2/8/64 and a mixed-depth batch; the port's
``run_netsim_batched(use_kernel=False, device="cpu")`` equals the
reference's candidate by candidate (every ``VerifyResult`` field,
``latency_full_ns`` bitwise, fallback flags) and the port's fixed point
(``use_kernel="on"``); and the reference's own batched-netsim contract
cases (``tests/test_batched_netsim.py``) hold for the port.  The CUDA
kernel runs only on a card: the ``cuda``-marked tests skip here
(``chip_smoke.py`` holds it to the plain version on the card).
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import inspect  # noqa: E402
import math  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import (ArchRequest, ForwardTableKind, SchedulerKind,  # noqa: E402
                        SwitchArch, VOQKind, bind, compressed_protocol,
                        enumerate_candidates)
from repro.sim import run_netsim_batched as ref_batched  # noqa: E402
from repro.sim.backannotate import annotate as ref_annotate  # noqa: E402
from repro.sim.batched_netsim import _verify_engine_impl  # noqa: E402
from repro.sim.netsim import service_times as ref_service_times  # noqa: E402
from repro.sim.timeline import stage4_timeline as ref_stage4  # noqa: E402
from repro.traces import datacenter, hft  # noqa: E402
from repro.traces.base import Trace as RefTrace  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import ResourceBudget, SLA, run_dse  # noqa: E402
from repro_torch.core.dse import DSEProblem  # noqa: E402
from repro_torch.kernels.ring_scan import kernel as ring_kernel  # noqa: E402
from repro_torch.kernels.ring_scan import ops as ring_ops  # noqa: E402
from repro_torch.kernels.ring_scan import ref as ring_ref  # noqa: E402
from repro_torch.kernels.ring_scan import ring_rows_per_chunk, ring_scan  # noqa: E402
from repro_torch.sim import run_netsim, run_netsim_batched  # noqa: E402
from repro_torch.sim.netsim import NetSimConfig  # noqa: E402
from repro_torch.sim.resources import ALVEO_U45N  # noqa: E402
from repro_torch.sim.switch_problem import SwitchDSEProblem  # noqa: E402

BOUND = bind(compressed_protocol(addr_bits=4, length_bits=6), flit_bits=256)
P_BOUND = convert.from_reference(BOUND)

_verify_engine = jax.jit(_verify_engine_impl, static_argnames=("n_ports", "d_max"))


def _traces():
    return {
        "hft": hft(seed=0),
        "datacenter": datacenter(seed=0, n_ports=8, duration_s=400e-6,
                                 load=0.8),
    }


def _sized_candidates(n_ports=8):
    """Every (bus, fwd, voq, sched) family at several sized depths — small
    depths force drops, as in the reference's test."""
    base = enumerate_candidates(ArchRequest(n_ports=n_ports, addr_bits=4))
    return [a.with_depth(d) for a in base[:12] for d in (2, 8, 64)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _engine_inputs(tr, archs):
    """The reference's stage-4 inputs for ``archs`` on ``tr``: timeline,
    svc in event order, pipe, depth, mod and d_max, as ``_run_group``
    builds them."""
    n = archs[0].n_ports
    tl4 = ref_stage4(tr, n, BOUND.header_bytes, 0.0)
    m = tl4.now.size
    svc = np.empty((len(archs), m))
    pipe = np.empty(len(archs))
    for b, a in enumerate(archs):
        hw = ref_annotate(a, BOUND, source="model")
        svc[b], pipe[b] = ref_service_times(a, hw, tl4.wire, tr.link_gbps * 1e9)
    depth = np.array([a.voq_depth for a in archs], np.int64)
    mod = np.minimum(np.maximum(depth, 1), m).astype(np.int32)
    d_max = 1 << int(int(mod.max()) - 1).bit_length()
    return (tl4.now, tl4.src_o.astype(np.int32), tl4.dst_o.astype(np.int32),
            svc[:, tl4.order], pipe, depth.astype(np.int32), mod, n, d_max)


# --------------------------------------------------------------------------
# the plain ring scan vs the reference's engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("depths", [(1,), (2,), (8,), (64,), (1, 2, 8, 64)],
                         ids=["d1", "d2", "d8", "d64", "mixed"])
@pytest.mark.parametrize("voq", ["nxn", "shared"])
@pytest.mark.parametrize("workload", ["hft", "datacenter"])
def test_plain_ring_scan_bitwise_vs_jax_engine(workload, voq, depths):
    tr = _traces()[workload]
    kind = VOQKind.NXN if voq == "nxn" else VOQKind.SHARED
    base = [a for a in enumerate_candidates(ArchRequest(n_ports=8, addr_bits=4))
            if a.voq is kind]
    archs = [base[k % len(base)].with_depth(depths[k % len(depths)])
             for k in range(4)]
    now, src, dst, svc, pipe, depth, mod, n, d_max = _engine_inputs(tr, archs)
    with jax.enable_x64(True):
        end_w, adm_w = _verify_engine(
            jnp.asarray(now), jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(svc.T), jnp.asarray(pipe), jnp.asarray(depth),
            jnp.asarray(mod), n_ports=n, d_max=d_max)
        end_w, adm_w = np.asarray(end_w), np.asarray(adm_w)
    end, adm = ring_scan(_t(now), _t(src), _t(dst), _t(svc), _t(pipe),
                         _t(depth), _t(mod), n_ports=n, d_max=d_max)
    assert end.dtype == torch.float64 and adm.dtype == torch.bool
    np.testing.assert_array_equal(end.numpy(), end_w)
    np.testing.assert_array_equal(adm.numpy(), adm_w)
    if min(depths) <= 2:
        assert not adm_w.all()                 # the small depths drop


def test_row_chunks_equal_one_call(monkeypatch):
    """Rows split under a ring budget give the one-call result bitwise."""
    tr = hft(seed=0).head(600)
    archs = [a.with_depth(d) for a, d in
             zip(enumerate_candidates(ArchRequest(n_ports=8, addr_bits=4)),
                 (1, 2, 3, 8, 64))]
    now, src, dst, svc, pipe, depth, mod, n, d_max = _engine_inputs(tr, archs)
    args = (_t(now), _t(src), _t(dst), _t(svc), _t(pipe), _t(depth), _t(mod))
    whole = ring_scan(*args, n_ports=n, d_max=d_max)
    monkeypatch.setattr(ring_ops, "RING_BUDGET_BYTES", 2 * n * n * d_max * 8)
    assert ring_rows_per_chunk(n, d_max) == 2            # two rows a chunk
    parts = ring_scan(*args, n_ports=n, d_max=d_max)
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1], parts[1])
    monkeypatch.setattr(ring_ops, "RING_BUDGET_BYTES", 1)
    assert ring_rows_per_chunk(300, 1024) == 1


# --------------------------------------------------------------------------
# run_netsim_batched(use_kernel=False) vs the reference and the fixed point
# --------------------------------------------------------------------------

def _assert_all_fields_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("drop_rate", "p99_latency_ns", "mean_latency_ns",
                  "throughput_gbps"):
            a, b = getattr(g, f), getattr(w, f)
            assert a == b or (math.isinf(a) and math.isinf(b)), (f, a, b)
        for k in ("delivered", "offered", "fallback", "shared_cap_fallback"):
            assert g.meta.get(k) == w.meta.get(k), k
        np.testing.assert_array_equal(g.meta["latency_ns"], w.meta["latency_ns"])
        np.testing.assert_array_equal(g.meta["latency_full_ns"],
                                      w.meta["latency_full_ns"])


@pytest.mark.parametrize("voq", ["nxn", "shared"])
@pytest.mark.parametrize("workload", ["hft", "datacenter"])
def test_ring_engine_equals_reference_and_fixed_point(workload, voq):
    tr = _traces()[workload]
    kind = VOQKind.NXN if voq == "nxn" else VOQKind.SHARED
    base = [a for a in enumerate_candidates(ArchRequest(n_ports=8, addr_bits=4))
            if a.voq is kind]
    cands = [a.with_depth(d) for a in base[:4] for d in (2, 8, 64)]
    want = ref_batched(cands, BOUND, tr, back_annotation=False,
                       use_kernel=False)
    pc, ptr = convert.from_reference(cands), convert.from_reference(tr)
    got = run_netsim_batched(pc, P_BOUND, ptr, back_annotation=False,
                             use_kernel=False, device="cpu")
    fixed = run_netsim_batched(pc, P_BOUND, ptr, back_annotation=False,
                               use_kernel="on", device="cpu")
    assert any(v.drop_rate > 0 for v in want)
    _assert_all_fields_equal(got, want)
    _assert_all_fields_equal(got, fixed)


def test_default_engine_is_the_ring_scan_as_in_the_reference():
    for fn in (run_netsim_batched, ref_batched):
        assert inspect.signature(fn).parameters["use_kernel"].default is False
    tr = convert.from_reference(hft(seed=0).head(200))
    cands = convert.from_reference(_sized_candidates()[:3])
    ring_kernel.LAUNCHES = 0
    calls = []
    real = ring_ref.ring_scan_ref

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    try:
        ring_ops.ring_scan_ref = spy
        run_netsim_batched(cands, P_BOUND, tr, back_annotation=False,
                           device="cpu")
    finally:
        ring_ops.ring_scan_ref = real
    assert calls and ring_kernel.LAUNCHES == 0     # plain version, no launch


# --------------------------------------------------------------------------
# the reference's contract cases (tests/test_batched_netsim.py), on the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("workload", ["hft", "datacenter"])
def test_batched_matches_heapq_oracle(workload):
    tr = convert.from_reference(_traces()[workload])
    cands = convert.from_reference(_sized_candidates())
    vb = run_netsim_batched(cands, P_BOUND, tr, back_annotation=False,
                            device="cpu")
    vs = [run_netsim(a, P_BOUND, tr, back_annotation=False) for a in cands]
    assert any(v.drop_rate > 0 for v in vs)     # the depths actually bind
    for a, b, s in zip(cands, vb, vs):
        msg = a.short()
        assert b.drop_rate == s.drop_rate, msg
        assert b.meta["delivered"] == s.meta["delivered"], msg
        np.testing.assert_array_equal(b.meta["latency_ns"],
                                      s.meta["latency_ns"], err_msg=msg)
        for q, sq in ((b.p99_latency_ns, s.p99_latency_ns),
                      (b.mean_latency_ns, s.mean_latency_ns)):
            assert q == pytest.approx(sq, rel=1e-3), msg
        assert b.throughput_gbps == pytest.approx(s.throughput_gbps, rel=1e-6), msg


def _incast_trace():
    n, per_src = 8, 120
    rng = np.random.default_rng(0)
    times = np.concatenate([np.arange(per_src) * 2.2e-7 + s * 1e-9
                            for s in range(n)])
    srcs = np.concatenate([np.full(per_src, s) for s in range(n)])
    dsts = np.concatenate([rng.integers(0, 4, per_src) for _ in range(n)])
    return RefTrace("incast4", times, srcs, dsts, np.full(n * per_src, 200), n,
                    link_gbps=10.0)


def test_shared_cap_fallback_is_exact():
    tr = _incast_trace()
    cands = [SwitchArch(n_ports=8, bus_bits=bw, fwd=ForwardTableKind.FULL_LOOKUP,
                        voq=voq, sched=SchedulerKind.RR, voq_depth=d, addr_bits=4)
             for bw in (128, 512)
             for voq in (VOQKind.SHARED, VOQKind.NXN) for d in (8, 16)]
    pc, ptr = convert.from_reference(cands), convert.from_reference(tr)
    vb = run_netsim_batched(pc, P_BOUND, ptr, back_annotation=False,
                            device="cpu")
    vs = [run_netsim(a, P_BOUND, ptr, back_annotation=False) for a in pc]
    fallbacks = [v.meta.get("shared_cap_fallback", False) for v in vb]
    assert any(fallbacks)                        # the cap genuinely binds
    assert not any(f for f, a in zip(fallbacks, cands)
                   if a.voq is VOQKind.NXN)      # ...and only for SHARED
    for b, s in zip(vb, vs):
        assert b.drop_rate == s.drop_rate
        np.testing.assert_array_equal(b.meta["latency_ns"],
                                      s.meta["latency_ns"])
    _assert_all_fields_equal(vb, ref_batched(cands, BOUND, tr,
                                             back_annotation=False))


def test_degenerate_depth_matches_serial():
    tr = hft(seed=0).head(64)
    cands = [_sized_candidates()[0].with_depth(0),
             _sized_candidates()[1].with_depth(8)]
    pc, ptr = convert.from_reference(cands), convert.from_reference(tr)
    vb = run_netsim_batched(pc, P_BOUND, ptr, back_annotation=False,
                            device="cpu")
    vs = [run_netsim(a, P_BOUND, ptr, back_annotation=False) for a in pc]
    assert vb[0].meta["fallback"] == "degenerate_depth"
    assert "fallback" not in vb[1].meta
    for b, s in zip(vb, vs):
        assert b.drop_rate == s.drop_rate
        np.testing.assert_array_equal(b.meta["latency_ns"], s.meta["latency_ns"])
    assert vs[0].drop_rate == 1.0
    _assert_all_fields_equal(vb, ref_batched(cands, BOUND, tr,
                                             back_annotation=False))


def test_empty_trace_and_empty_batch():
    from repro_torch.traces.base import Trace
    empty = Trace("empty", np.zeros(0), np.zeros(0, np.int32),
                  np.zeros(0, np.int32), np.zeros(0, np.int64), 8)
    cands = convert.from_reference(_sized_candidates()[:4])
    vb = run_netsim_batched(cands, P_BOUND, empty, back_annotation=False,
                            device="cpu")
    vs = run_netsim(cands[0], P_BOUND, empty, back_annotation=False)
    assert len(vb) == 4
    for v in vb:
        assert v.drop_rate == vs.drop_rate == 0.0
        assert v.throughput_gbps == vs.throughput_gbps == 0.0
        assert math.isinf(v.p99_latency_ns) and math.isinf(vs.p99_latency_ns)
    assert run_netsim_batched([], P_BOUND, convert.from_reference(hft(seed=0)),
                              device="cpu") == []


def test_single_candidate():
    tr = convert.from_reference(hft(seed=1))
    a = convert.from_reference(_sized_candidates()[0])
    [vb] = run_netsim_batched([a], P_BOUND, tr, back_annotation=False,
                              device="cpu")
    vs = run_netsim(a, P_BOUND, tr, back_annotation=False)
    assert vb.drop_rate == vs.drop_rate
    np.testing.assert_array_equal(vb.meta["latency_ns"], vs.meta["latency_ns"])


def test_mixed_port_batches_are_partitioned():
    tr = hft(seed=0).head(1500)
    mixed = ([a.with_depth(4) for a in
              enumerate_candidates(ArchRequest(n_ports=8, addr_bits=4))[:3]]
             + [a.with_depth(4) for a in
                enumerate_candidates(ArchRequest(n_ports=4, addr_bits=4))[:3]])
    pm, ptr = convert.from_reference(mixed), convert.from_reference(tr)
    vb = run_netsim_batched(pm, P_BOUND, ptr, back_annotation=False,
                            device="cpu")
    for a, b in zip(pm, vb):
        s = run_netsim(a, P_BOUND, ptr, back_annotation=False)
        assert b.drop_rate == s.drop_rate
        np.testing.assert_array_equal(b.meta["latency_ns"], s.meta["latency_ns"])
    _assert_all_fields_equal(vb, ref_batched(mixed, BOUND, tr,
                                             back_annotation=False))


def test_retransmit_stays_serial():
    bound_seq = convert.from_reference(
        bind(compressed_protocol(addr_bits=4, seq_bits=8), flit_bits=256))
    with pytest.raises(NotImplementedError, match="retransmission"):
        run_netsim_batched(convert.from_reference(_sized_candidates()[:2]),
                           bound_seq, convert.from_reference(hft(seed=0)),
                           cfg=NetSimConfig(retransmit=True),
                           back_annotation=False, device="cpu")


def test_misaligned_hw_list_raises():
    with pytest.raises(ValueError, match="index-aligned"):
        run_netsim_batched(convert.from_reference(_sized_candidates()[:4]),
                           P_BOUND, convert.from_reference(hft(seed=0)),
                           hw=[None, None], device="cpu")


class _SerialVerifyProblem(SwitchDSEProblem):
    """The same problem forced through the serial stage-4 fallback."""
    verify_batch = DSEProblem.verify_batch


def test_run_dse_identical_batched_vs_serial_verify():
    """``run_dse`` through the ring-scan engine gives the serial path's
    Pareto front."""
    tr = convert.from_reference(hft(seed=0))
    req = convert.from_reference(ArchRequest(n_ports=8, addr_bits=4))
    sla = SLA(p99_latency_ns=5000, drop_rate=1e-3)
    budget = ResourceBudget(dict(ALVEO_U45N))
    ring_kernel.LAUNCHES = 0
    res_b = run_dse(SwitchDSEProblem(req, P_BOUND, tr, back_annotation=False,
                                     use_kernel="off", device="cpu"),
                    sla, budget)
    res_s = run_dse(_SerialVerifyProblem(req, P_BOUND, tr,
                                         back_annotation=False, device="cpu"),
                    sla, budget)
    assert res_b.pareto
    assert sorted(a.short() for a, _ in res_b.pareto) == \
           sorted(a.short() for a, _ in res_s.pareto)
    assert ring_kernel.LAUNCHES == 0


# --------------------------------------------------------------------------
# on the card only
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n_ports,depths", [
    (8, (1, 2, 8, 64, 1024, 0)), (32, (1, 2, 8, 64)), (64, (1, 8, 1024)),
    (300, (1, 2, 8))])
def test_cuda_kernel_bitwise_vs_plain(n_ports, depths):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    rng = np.random.default_rng(n_ports)
    m, b = 777, len(depths)
    gaps = rng.exponential(2e-8, m)
    gaps[0] = 0.0
    now = np.cumsum(gaps)
    src = rng.integers(0, n_ports, m).astype(np.int32)
    dst = rng.integers(0, n_ports, m).astype(np.int32)
    svc = rng.uniform(1e-8, 8e-8, (b, m))
    pipe = rng.uniform(1e-8, 5e-8, b)
    depth = np.array(depths, np.int32)
    mod = np.minimum(np.maximum(depth, 1), m).astype(np.int32)
    d_max = 1 << int(int(mod.max()) - 1).bit_length()
    dev = torch.device("cuda")
    T = lambda a: torch.tensor(a, device=dev)                 # noqa: E731
    got = ring_kernel.ring_scan(T(now), T(src), T(dst), T(svc).t().contiguous(),
                                T(pipe), T(depth), T(mod), n_ports=n_ports,
                                d_max=d_max)
    want = ring_ref.ring_scan_ref(T(now), T(src), T(dst), T(svc), T(pipe),
                                  T(depth), T(mod), n_ports=n_ports, d_max=d_max)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
