"""The port's crossbar-contention family (``repro_torch.kernels.xbar``) and
batched stage-2 engine (``repro_torch.sim.batched_surrogate``) against the
JAX package.

Contract: the plain PyTorch scans are bitwise equal to the JAX float64
oracle (absolute form) and to the float32 slack oracle and Pallas tile run
in interpret mode (slack form), for 8 and 32 ports; ``run_surrogate_batched``
on the CPU gives ``dep_end_s`` bitwise, ``q_occupancy`` exactly, quantiles
and throughput equal to the reference's on hft and datacenter.  Inputs come
from ``np.random.default_rng(seed)`` and go to both packages as NumPy.  The
CUDA kernel itself runs only on a card: the ``cuda``-marked tests skip here.
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

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import (ArchRequest, bind, compressed_protocol,  # noqa: E402
                        enumerate_candidates)
from repro.kernels.xbar import xbar_contend as jax_xbar_contend  # noqa: E402
from repro.kernels.xbar.ref import (xbar_contend_abs_ref,  # noqa: E402
                                    xbar_contend_slack_ref)
from repro.sim import run_surrogate_batched as ref_batched  # noqa: E402
from repro.traces import datacenter, hft  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.kernels.xbar import kernel as port_kernel  # noqa: E402
from repro_torch.kernels.xbar import ref as port_ref  # noqa: E402
from repro_torch.kernels.xbar import xbar_contend  # noqa: E402
from repro_torch.sim import run_surrogate_batched  # noqa: E402

BOUND = bind(compressed_protocol(addr_bits=5, length_bits=6), flit_bits=256)


def _inputs(seed, m, b, n):
    """A sorted timeline with real contention (gaps below service times)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(2e-8, m)
    gaps[0] = 0.0
    t = np.cumsum(gaps)
    dt = np.diff(t, prepend=t[:1])
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    svc = rng.uniform(1e-8, 8e-8, (b, m))
    return t, dt, src, dst, svc


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# plain scans vs the JAX oracles and the Pallas tile
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_ports", [8, 32])
def test_abs_scan_bitwise_vs_jax_f64(n_ports):
    t, _, src, dst, svc = _inputs(0, 300, 6, n_ports)
    with jax.enable_x64(True):
        want = np.asarray(xbar_contend_abs_ref(
            jnp.asarray(t), jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(svc), n_ports=n_ports))
    got = port_ref.xbar_contend_abs_ref(_t(t), _t(src), _t(dst), _t(svc),
                                        n_ports=n_ports)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_ports", [8, 32])
def test_slack_scan_bitwise_vs_jax_oracle_and_pallas_tile(n_ports):
    t, dt, src, dst, svc = _inputs(1, 200, 10, n_ports)
    dt32, svc32 = dt.astype(np.float32), svc.astype(np.float32)
    want = np.asarray(xbar_contend_slack_ref(
        jnp.asarray(dt32), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(svc32), n_ports=n_ports))
    tile = np.asarray(jax_xbar_contend(
        jnp.asarray(t, jnp.float32), jnp.asarray(dt32), jnp.asarray(src),
        jnp.asarray(dst), jnp.asarray(svc32), n_ports=n_ports,
        use_pallas=True, interpret=True))
    got = port_ref.xbar_contend_slack_ref(_t(dt32), _t(src), _t(dst),
                                          _t(svc32), n_ports=n_ports)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tile)


def test_op_dispatches_by_dtype_on_cpu_without_launching():
    t, dt, src, dst, svc = _inputs(2, 64, 3, 8)
    port_kernel.LAUNCHES = 0
    dep64 = xbar_contend(_t(t), _t(dt), _t(src), _t(dst), _t(svc), n_ports=8)
    dep32 = xbar_contend(_t(t).float(), _t(dt).float(), _t(src), _t(dst),
                         _t(svc).float(), n_ports=8)
    assert port_kernel.LAUNCHES == 0
    np.testing.assert_array_equal(
        dep64.numpy(), port_ref.xbar_contend_abs_ref(
            _t(t), _t(src), _t(dst), _t(svc), n_ports=8).numpy())
    assert dep32.dtype == torch.float32
    with pytest.raises(ValueError, match="absolute"):
        xbar_contend(_t(t).float(), _t(dt).float(), _t(src), _t(dst),
                     _t(svc).float(), n_ports=8, absolute=True)


def test_kernel_binding_refuses_cpu_tensors():
    t, _, src, dst, svc = _inputs(3, 16, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        port_kernel.xbar_scan(_t(t), _t(src), _t(dst), _t(svc.T.copy()),
                              n_ports=8, absolute=True)


# --------------------------------------------------------------------------
# the batched stage-2 engine
# --------------------------------------------------------------------------

def _workloads():
    return {"hft": (hft(seed=0), 8),
            "datacenter": (datacenter(seed=0), 32)}


@pytest.mark.parametrize("workload", ["hft", "datacenter"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_batched_surrogate_matches_reference(workload, use_kernel):
    trace, n = _workloads()[workload]
    cands = enumerate_candidates(ArchRequest(n_ports=n, addr_bits=5))[::3]
    want = ref_batched(cands, BOUND, trace, back_annotation=False,
                       use_kernel=use_kernel)
    got = run_surrogate_batched(
        convert.from_reference(cands), convert.from_reference(BOUND),
        convert.from_reference(trace), back_annotation=False,
        use_kernel=use_kernel, device="cpu")
    np.testing.assert_array_equal(got.dep_end_s, want.dep_end_s)
    np.testing.assert_array_equal(got.q_occupancy, want.q_occupancy)
    np.testing.assert_array_equal(got.latency_ns, want.latency_ns)
    np.testing.assert_array_equal(got.quantiles, want.quantiles)
    np.testing.assert_array_equal(got.throughput_gbps, want.throughput_gbps)
    np.testing.assert_array_equal(got.line_rate_feasible,
                                  want.line_rate_feasible)
    for rg, rw in zip(got.results(), want.results()):
        a, b = rg.meta["shared_occupancy"], rw.meta["shared_occupancy"]
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_float32_precision_matches_reference_slack_path():
    """precision="float32" is the port's use_pallas=True: the slack scan,
    bitwise equal to the reference's float32 path and its Pallas tile."""
    trace = hft(seed=1).head(400)
    cands = enumerate_candidates(ArchRequest(n_ports=8, addr_bits=5))[:6]
    want = ref_batched(cands, BOUND, trace, back_annotation=False,
                       precision="float32")
    tile = ref_batched(cands, BOUND, trace, back_annotation=False,
                       use_pallas=True)
    got = run_surrogate_batched(
        convert.from_reference(cands), convert.from_reference(BOUND),
        convert.from_reference(trace), back_annotation=False,
        precision="float32", device="cpu")
    assert got.meta["precision"] == "float32"
    for w in (want, tile):
        np.testing.assert_array_equal(got.dep_end_s, w.dep_end_s)
        np.testing.assert_array_equal(got.latency_ns, w.latency_ns)
        np.testing.assert_array_equal(got.throughput_gbps, w.throughput_gbps)
        np.testing.assert_array_equal(got.q_occupancy, w.q_occupancy)


def test_mixed_port_batch_is_stitched_in_input_order():
    trace = hft(seed=0).head(500)
    c8 = enumerate_candidates(ArchRequest(n_ports=8, addr_bits=5))[:3]
    c16 = enumerate_candidates(ArchRequest(n_ports=16, addr_bits=5))[:3]
    cands = [c8[0], c16[0], c8[1], c16[1], c16[2], c8[2]]
    want = ref_batched(cands, BOUND, trace, back_annotation=False)
    got = run_surrogate_batched(
        convert.from_reference(cands), convert.from_reference(BOUND),
        convert.from_reference(trace), back_annotation=False, device="cpu")
    np.testing.assert_array_equal(got.dep_end_s, want.dep_end_s)
    np.testing.assert_array_equal(got.q_occupancy, want.q_occupancy)
    np.testing.assert_array_equal(got.quantiles, want.quantiles)


def test_empty_batch_and_empty_trace():
    from repro_torch.traces.base import Trace
    assert run_surrogate_batched([], convert.from_reference(BOUND),
                                 convert.from_reference(hft(seed=0)),
                                 device="cpu").results() == []
    empty = Trace("empty", np.zeros(0), np.zeros(0, np.int32),
                  np.zeros(0, np.int32), np.zeros(0, np.int64), 8)
    cands = convert.from_reference(
        enumerate_candidates(ArchRequest(n_ports=8, addr_bits=5))[:4])
    batch = run_surrogate_batched(cands, convert.from_reference(BOUND), empty,
                                  back_annotation=False, device="cpu")
    assert batch.latency_ns.shape == (4, 0)
    assert batch.q_occupancy.shape == (4, 0)


# --------------------------------------------------------------------------
# on the card only
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n_ports,absolute", [(8, True), (32, True),
                                              (8, False), (32, False)])
def test_cuda_kernel_bitwise_vs_plain(n_ports, absolute):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    t, dt, src, dst, svc = _inputs(4, 1000, 20, n_ports)
    dev = torch.device("cuda")
    dtype = torch.float64 if absolute else torch.float32
    tdt = torch.tensor(t if absolute else dt, dtype=dtype, device=dev)
    s = torch.tensor(svc, dtype=dtype, device=dev)
    si, di = torch.tensor(src, device=dev), torch.tensor(dst, device=dev)
    got = port_kernel.xbar_scan(tdt, si, di, s.t().contiguous(),
                                n_ports=n_ports, absolute=absolute)
    plain = (port_ref.xbar_contend_abs_ref if absolute
             else port_ref.xbar_contend_slack_ref)
    assert torch.equal(got, plain(tdt, si, di, s, n_ports=n_ports))
