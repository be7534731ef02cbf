"""Custom-kernel hooks (§III-B.5) in the port's cycle-level switch, against
the eager loop and the JAX package.

Contract, on the CPU: the switch loop's plain ingress pass, the hooks
stepped once a cycle (``hooks.run_hooks``) and the plain egress pass give
the fused eager loop's ``SwitchLoopOut`` bit for bit, for every forward
table x VOQ x scheduler case of ``test_torch_switch_loop.py`` and an
identity, a dropping and a rewriting hook (out -1, -2, a port, values
outside the ports and outside int32, a lane with no packet marked valid);
so does the card's dispatch glue (``ops.hooked_passes``) with its two
launches stood in for by those plain passes.  ``simulate`` with the
example's PyTorch aggregation hook equals the reference's ``simulate``
with its JAX hook on ``rl_allreduce(rounds=2, chunks_per_round=2)``, and a
``run_scenario`` whose ``ArchRequest`` carries the aggregation kernel, its
``fn`` reattached, verified on the cycle-level switch, equals the
reference's under ``diff_reports``.  The ``cuda``-marked tests hold the
kernel's two passes to their plain versions on a card and skip here.
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import (ForwardTableKind, SchedulerKind, VOQKind, bind,  # noqa: E402
                        compressed_protocol)
from repro.switch.switch import simulate as ref_simulate  # noqa: E402
from repro.traces import rl_allreduce as ref_rl_allreduce  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import archspec as pa  # noqa: E402
from repro_torch.kernels.switch_loop import hooks  # noqa: E402
from repro_torch.kernels.switch_loop import kernel as loop_kernel  # noqa: E402
from repro_torch.kernels.switch_loop import ops as loop_ops  # noqa: E402
from repro_torch.kernels.switch_loop import (egress_ref, ingress_ref,  # noqa: E402
                                             switch_loop_ref)
from repro_torch.switch import switch as sw  # noqa: E402
from repro_torch.traces import rl_allreduce  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_switch_loop as tsl  # noqa: E402
from test_golden import diff_reports  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the all-reduce trace both packages simulate: two rounds of two chunks
#: (8,631 cycles; round 2's incast hits the learned aggregator port)
ALLREDUCE = dict(seed=0, n_ports=8, rounds=2, chunks_per_round=2)


def _example(name):
    """An example script as a module (its top level only defines)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _identity(kst, pids, out_port, valid, cyc):
    return kst, out_port, valid


def _dropping(kst, pids, out_port, valid, cyc):
    """Drops every packet of odd id; counts the drops in its state."""
    drop = valid & (pids % 2 == 1)
    return kst + drop.sum(), out_port, valid & ~drop


#: what the rewriting hook writes: no queue, a broadcast, a port, a port the
#: switch does not have, a negative value other than -1 and -2, and a value
#: outside int32
REWRITES = (-1, -2, 3, 99, -7, 1 << 40)


def _rewriting(kst, pids, out_port, valid, cyc):
    """Each cycle rewrites lane (cycle mod N)'s out (``REWRITES`` in turn),
    and marks the next lane valid with a rewritten out, packet or not."""
    k, n = int(cyc), pids.shape[0]
    out_port, valid = out_port.clone(), valid.clone()
    out_port[k % n] = REWRITES[k % len(REWRITES)]
    out_port[(k + 1) % n] = REWRITES[(k // n) % len(REWRITES)]
    valid[(k + 1) % n] = True
    return kst, out_port, valid


HOOKS = {"identity": (_identity, None), "dropping": (_dropping, 0),
         "rewriting": (_rewriting, None)}


def _hooked(arch, name):
    fn, state = HOOKS[name]
    spec = pa.CustomKernelSpec(name, fn=fn)
    if state is not None:
        object.__setattr__(spec, "init_state", torch.tensor(state))
    # a declared-only kernel beside it: it has no fn and is not called
    return dataclasses.replace(arch, custom_kernels=(pa.CustomKernelSpec("iface"), spec))


def _case_inputs(case, device="cpu"):
    fwd, voq, sched, n, iters, cycles = case
    arch = convert.from_reference(tsl._arch(fwd, voq, sched, n, iters,
                                            depth=1 if n == 8 else 2))
    bound, trace = tsl._inputs(n)
    _, arr, words, sizes, keys = tsl._loop_inputs(
        arch, convert.from_reference(bound), convert.from_reference(trace), cycles, device)
    return arch, arr, words, sizes, keys


def _assert_out_equal(got, want):
    for f, g, w in zip(want._fields, got, want):
        assert g.dtype == w.dtype, f
        assert torch.equal(g, w), f


@pytest.mark.parametrize("hook", sorted(HOOKS))
@pytest.mark.parametrize("case", tsl.CASES, ids=tsl._case_id)
def test_passes_compose_to_the_eager_loop(case, hook, monkeypatch):
    arch, arr, words, sizes, keys = _case_inputs(case)
    arch = _hooked(arch, hook)
    want = switch_loop_ref(arch, arr, words, sizes, keys)
    out = ingress_ref(arch, arr, words, keys)
    assert out.dtype == torch.int32 and out.shape == arr.shape
    assert set(out.unique().tolist()) <= {-2, -1} | set(range(arch.n_ports))
    out_h, valid_h = hooks.run_hooks(arch, arr, out)
    assert out_h.dtype == torch.int64 and valid_h.dtype == torch.bool
    _assert_out_equal(egress_ref(arch, arr, out_h, valid_h, sizes), want)
    # the card's glue between the two launches, the launches stood in for
    # by the plain passes
    monkeypatch.setattr(loop_kernel, "switch_ingress_launch",
                        lambda a, p, w, k: ingress_ref(a, p, w, k))
    monkeypatch.setattr(loop_kernel, "switch_egress_launch",
                        lambda a, p, o, v, s: egress_ref(a, p, o, v, s))
    got = loop_ops.hooked_passes(arch, arr.to(torch.int32), words.to(torch.uint32),
                                 sizes.to(torch.int32), keys)
    _assert_out_equal(got, want)
    if hook == "identity":
        _assert_out_equal(want, switch_loop_ref(dataclasses.replace(
            arch, custom_kernels=()), arr, words, sizes, keys))
    if hook == "rewriting":
        # lanes with no packet queued, to a port and to every port
        empty = valid_h & (arr < 0)
        assert (empty & (out_h == 3)).any() and (empty & (out_h == -2)).any()
        assert ((out_h == 99) & valid_h).any() and ((out_h == 1 << 40) & valid_h).any()


def test_hooks_see_every_cycle_in_order():
    calls = []

    def first(kst, pids, out_port, valid, cyc):
        assert pids.dtype == out_port.dtype == torch.int64 and valid.dtype == torch.bool
        assert cyc.dtype == torch.int64 and cyc.dim() == 0 and pids.device.type == "cpu"
        calls.append(("first", int(cyc), kst))
        return kst + 1, out_port + 0, valid

    def second(kst, pids, out_port, valid, cyc):
        calls.append(("second", int(cyc), kst))
        return kst, torch.where(valid, 5, out_port), valid

    arch = dataclasses.replace(
        tsl._port_arch(8, pa.ForwardTableKind.FULL_LOOKUP, pa.VOQKind.NXN,
                       pa.SchedulerKind.RR, 4, 4),
        custom_kernels=(pa.CustomKernelSpec("a", fn=first), pa.CustomKernelSpec("b", fn=second)))
    object.__setattr__(arch.custom_kernels[0], "init_state", 10)
    arr = torch.full((4, 8), -1, dtype=torch.int32)
    arr[2, 3] = 0
    out = torch.full((4, 8), -1, dtype=torch.int32)
    out[2, 3] = -2
    out_h, valid_h = hooks.run_hooks(arch, arr, out)
    assert calls == [(s, k, 10 + k if s == "first" else None) for k in range(4)
                     for s in ("first", "second")]
    assert valid_h.sum() == 1 and out_h[2, 3] == 5 and (out_h[valid_h == 0] == -1).all()
    assert hooks.has_hooks(arch)
    assert not hooks.has_hooks(dataclasses.replace(
        arch, custom_kernels=(pa.CustomKernelSpec("iface"),)))


@pytest.mark.parametrize("name,arch,table_shared,ring_shared", [
    (name, arch, ts, rs) for name, arch, ts, rs in [
        ("hft", tsl._port_arch(8, pa.ForwardTableKind.FULL_LOOKUP, pa.VOQKind.NXN,
                               pa.SchedulerKind.RR, 288, 4), True, True),
        ("deep", tsl._port_arch(32, pa.ForwardTableKind.MULTIBANK_HASH, pa.VOQKind.SHARED,
                                pa.SchedulerKind.EDRRM, 2048, 32), True, False),
        ("wide_table", tsl._port_arch(32, pa.ForwardTableKind.FULL_LOOKUP, pa.VOQKind.NXN,
                                      pa.SchedulerKind.RR, 2048, 16), False, False)]])
def test_plan_of_each_pass(name, arch, table_shared, ring_shared):
    """Ingress keeps only the forward table (in shared memory where it fits
    alone: not a 16-bit full lookup, 256 KiB), egress the queue counters
    and the ring."""
    fused = loop_kernel.plan(arch, 100)
    ing, eg = loop_kernel.plan(arch, 100, "ingress"), loop_kernel.plan(arch, 100, "egress")
    counters = 3 * arch.n_ports * (arch.n_ports + 1) * 4
    assert (fused.table_shared, fused.ring_shared) == (table_shared, ring_shared)
    assert ing.ring_words == 0 and ing.table_words == fused.table_words
    assert ing.table_shared == (name != "wide_table")
    assert ing.smem_bytes == 4 * ing.table_words * ing.table_shared
    assert eg.table_words == 0 and eg.ring_words == fused.ring_words
    assert eg.ring_shared == ring_shared
    assert eg.smem_bytes == counters + 4 * eg.ring_words * ring_shared
    with pytest.raises(ValueError, match="mode"):
        loop_kernel.plan(arch, 100, "hooks")


def test_pass_wrappers_take_cuda_tensors_only():
    arch, arr, words, sizes, keys = _case_inputs(tsl.CASES[0])
    arr32 = arr.to(torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        loop_kernel.switch_ingress_launch(arch, arr32, words.to(torch.uint32), keys)
    with pytest.raises(ValueError, match="CUDA"):
        loop_kernel.switch_egress_launch(arch, arr32, arr32, arr >= 0, sizes)


def test_hook_exception_propagates():
    def broken(kst, pids, out_port, valid, cyc):
        raise RuntimeError("hook failed")
    arch, arr, words, sizes, keys = _case_inputs(tsl.CASES[0])
    arch = dataclasses.replace(arch, custom_kernels=(pa.CustomKernelSpec("x", fn=broken),))
    with pytest.raises(RuntimeError, match="hook failed"):
        hooks.run_hooks(arch, arr, ingress_ref(arch, arr, words, keys))


def _allreduce_archs(ref_mod, port_mod):
    """The example's hooked switch in both packages."""
    from repro.core import SwitchArch as RefArch
    kw = dict(n_ports=8, bus_bits=1024, fwd=ForwardTableKind.FULL_LOOKUP,
              voq=VOQKind.NXN, sched=SchedulerKind.EDRRM, voq_depth=512, addr_bits=4)
    ref_arch = RefArch(**kw, custom_kernels=(ref_mod.make_aggregation_kernel(7),))
    port_arch = port_mod.architectures(8)[1][1]
    return ref_arch, port_arch


def test_simulate_with_aggregation_hook_equals_reference():
    ref_mod = _example("inswitch_allreduce")
    port_mod = _example("inswitch_allreduce_torch")
    ref_arch, port_arch = _allreduce_archs(ref_mod, port_mod)
    assert port_arch.custom_kernels[0].fn is not None
    assert convert.from_reference(dataclasses.replace(ref_arch, custom_kernels=())) \
        == dataclasses.replace(port_arch, custom_kernels=())
    bound = bind(compressed_protocol(addr_bits=4, length_bits=12), flit_bits=1024)
    fclk = 157.40e6
    want = ref_simulate(ref_arch, bound, ref_rl_allreduce(**ALLREDUCE), fclk_hz=fclk)
    got = sw.simulate(port_arch, convert.from_reference(bound), rl_allreduce(**ALLREDUCE),
                      fclk_hz=fclk, device="cpu")
    assert got.n_cycles == want.n_cycles == 8631
    np.testing.assert_array_equal(got.latency_cycles, want.latency_cycles)
    for k in ("occ_trace", "occ_max"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert (got.drops, got.delivered_copies, got.data_slots_max) == \
        (want.drops, want.delivered_copies, want.data_slots_max)
    # round 2's incast finds the aggregator learned: the hook absorbs it
    assert got.delivered_copies == 128


def test_run_scenario_with_reattached_hook_equals_reference():
    from repro.api import registry as ref_registry
    from repro.api import run_scenario as ref_run_scenario
    from repro_torch.api import registry as port_registry
    from repro_torch.api import run_scenario
    ref_mod = _example("inswitch_allreduce")
    port_mod = _example("inswitch_allreduce_torch")
    spec = dict(trace_params={"duration_s": 2e-05}, verify_engine="cycle",
                back_annotation=False, top_k=2)

    def with_hook(scen, kernel):
        return dataclasses.replace(scen, arch=dataclasses.replace(
            scen.arch, custom_kernels=(kernel,)))
    want = ref_run_scenario(with_hook(ref_registry["hft"].override(**spec),
                                      ref_mod.make_aggregation_kernel(7)))
    got = run_scenario(with_hook(port_registry["hft"].override(**spec),
                                 port_mod.make_aggregation_kernel(7)), device="cpu")
    doc = json.loads(json.dumps(got.to_dict()))
    assert doc["scenario"]["arch"]["custom_kernels"][0]["name"] == "allreduce_agg"
    errors = diff_reports(doc, json.loads(json.dumps(want.to_dict())))
    assert not errors, "\n".join(errors)
    assert got.best.custom_kernels[0].fn is not None
    assert got.best_verify.meta["engine"] == "cycle"


# --------------------------------------------------------------------------
# on the card only
# --------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hook", sorted(HOOKS))
@pytest.mark.parametrize("case", tsl.CASES, ids=tsl._case_id)
def test_cuda_passes_bitwise_vs_plain(case, hook):
    dev = _cuda()
    arch, arr, words, sizes, keys = _case_inputs(case, dev)
    arch = _hooked(arch, hook)
    arr32 = arr.to(torch.int32)
    n0, e0 = loop_kernel.INGRESS_LAUNCHES, loop_kernel.EGRESS_LAUNCHES
    out = loop_kernel.switch_ingress_launch(arch, arr32, words.to(torch.uint32), keys)
    assert torch.equal(out, ingress_ref(arch, arr, words, keys))
    out_h, valid_h = hooks.run_hooks(arch, arr.cpu(), out.cpu())
    want = egress_ref(arch, arr, out_h.to(dev), valid_h.to(dev), sizes)
    got = loop_ops.switch_loop(arch, arr, words, sizes, keys)
    torch.cuda.synchronize()
    assert (loop_kernel.INGRESS_LAUNCHES, loop_kernel.EGRESS_LAUNCHES) == (n0 + 2, e0 + 1)
    _assert_out_equal(got, want)
    _assert_out_equal([g.cpu() for g in got],
                      switch_loop_ref(arch, arr.cpu(), words.cpu(), sizes.cpu(), keys))


@pytest.mark.cuda
def test_cuda_simulate_with_aggregation_hook_equals_cpu():
    dev = _cuda()
    port_mod = _example("inswitch_allreduce_torch")
    port_arch = port_mod.architectures(8)[1][1]
    bound = convert.from_reference(bind(compressed_protocol(addr_bits=4, length_bits=12),
                                        flit_bits=1024))
    trace = rl_allreduce(**ALLREDUCE)
    got = sw.simulate(port_arch, bound, trace, fclk_hz=157.40e6, device=dev)
    want = sw.simulate(port_arch, bound, trace, fclk_hz=157.40e6, device="cpu")
    tsl._assert_sim_equal(got, want)
