"""The port's fused cycle loop (``repro_torch.kernels.switch_loop``) against
the JAX package's cycle-level switch.

Contract, on the CPU: the loop's plain version (``switch_loop_ref``, the
eager loop over the table, VOQ and scheduler modules) gives the reference
``simulate``'s ``SwitchSimResult`` exactly, for every forward table x VOQ x
scheduler combination and for iSLIP at 3 and 32 ports with 1-4 rounds;
``simulate`` sends every architecture through the op, which runs the eager
loop on the CPU, a Python custom-kernel ``fn`` included, and on a card the
fused launch, or for a ``fn`` the ingress pass, the hooks and the egress
pass; the wrapper refuses CPU tensors, more than 32 ports and a custom
``fn`` (the passes run it); ``plan`` keeps hft's and
datacenter's rung-4 champions in shared memory and a 32-port, depth-2,048
ring in device memory.  Inputs come from the reference's seeded trace
generators and go to both packages as NumPy.  The CUDA kernel runs only on
a card: the ``cuda``-marked tests hold it to the plain version bit for bit
there and skip here.
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import ctypes  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import (ForwardTableKind, SchedulerKind, SwitchArch,  # noqa: E402
                        VOQKind, bind, compressed_protocol)
from repro.switch.switch import simulate as ref_simulate  # noqa: E402
from repro.traces import hft, uniform  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import archspec as pa  # noqa: E402
from repro_torch.kernels.parser import slices  # noqa: E402
from repro_torch.kernels.switch_loop import kernel as loop_kernel  # noqa: E402
from repro_torch.kernels.switch_loop import ops as loop_ops  # noqa: E402
from repro_torch.kernels.switch_loop import ref as loop_ref  # noqa: E402
from repro_torch.kernels.switch_loop import switch_loop, switch_loop_ref  # noqa: E402
from repro_torch.switch import switch as sw  # noqa: E402

FCLK = 2.5e8

#: (fwd, voq, sched, n_ports, islip_iters, max_cycles): the 12 kinds at 8
#: ports, then iSLIP at 3 and 32 ports with 1-4 rounds over both tables and
#: both VOQs
CASES = [(f, v, s, 8, 2, 500) for f in ForwardTableKind for v in VOQKind
         for s in SchedulerKind]
CASES += [(f, v, SchedulerKind.ISLIP, n, it, 500 if n == 3 else 300)
          for n in (3, 32)
          for it, (f, v) in zip((1, 2, 3, 4), [
              (ForwardTableKind.FULL_LOOKUP, VOQKind.NXN),
              (ForwardTableKind.MULTIBANK_HASH, VOQKind.SHARED),
              (ForwardTableKind.FULL_LOOKUP, VOQKind.SHARED),
              (ForwardTableKind.MULTIBANK_HASH, VOQKind.NXN)])]


def _case_id(c):
    f, v, s, n, it, _ = c
    return f"{f.value}-{v.value}-{s.value}-n{n}-it{it}"


def _inputs(n):
    """(bound, trace) at the test_torch_switch sizes: hft at 8 ports, and
    uniform traffic that overloads the 3- and 32-port switches."""
    if n == 8:
        return (bind(compressed_protocol(addr_bits=4, length_bits=12), flit_bits=256),
                hft(seed=3, duration_s=2e-6))
    return (bind(compressed_protocol(addr_bits=5, length_bits=12), flit_bits=256),
            uniform(seed=7, n_ports=n, duration_s=1e-6, link_gbps=400.0,
                    load=0.9 if n == 32 else 0.3, payload=64))


def _arch(fwd, voq, sched, n, iters, depth=1):
    return SwitchArch(n_ports=n, bus_bits=128, fwd=fwd, voq=voq, sched=sched,
                      voq_depth=depth, hash_banks=2, hash_depth=8, islip_iters=iters,
                      addr_bits=4 if n == 8 else 5)


def _loop_inputs(arch, bound, trace, max_cycles, device="cpu"):
    """The op's inputs as ``simulate`` makes them (arr_pid, header words,
    sizes, the keys' baked slices), and the binned trace."""
    prep = sw.prepare_cycle_inputs(arch, bound, trace, FCLK, max_cycles=max_cycles)
    keys = slices(bound.protocol, [bound.semantics["routing_key"],
                                   bound.semantics["src_key"]]).baked
    return (prep, torch.from_numpy(prep["arr_pid"]).to(device),
            torch.from_numpy(prep["header_words"]).to(device),
            torch.from_numpy(prep["size_flits"]).to(device), keys)


def _sim_fields(r):
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}


def _assert_sim_equal(got, want):
    g, w = _sim_fields(got), _sim_fields(want)
    assert g.keys() == w.keys()
    for k in w:
        if isinstance(w[k], np.ndarray):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            assert g[k] == w[k], k


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ref_equals_reference_simulate(case):
    fwd, voq, sched, n, iters, cycles = case
    arch = _arch(fwd, voq, sched, n, iters, depth=1 if n == 8 else 2)
    bound, trace = _inputs(n)
    want = ref_simulate(arch, bound, trace, fclk_hz=FCLK, max_cycles=cycles)
    parch, pbound = convert.from_reference(arch), convert.from_reference(bound)
    prep, arr, words, sizes, keys = _loop_inputs(
        parch, pbound, convert.from_reference(trace), cycles)
    out = switch_loop_ref(parch, arr, words, sizes, keys)
    assert out.dep_cycle.dtype == out.occ_trace.dtype == out.occ_max.dtype == torch.int64
    _assert_sim_equal(sw.sim_result(parch, prep, out, FCLK), want)
    # the op takes the plain version for CPU tensors
    for a, b in zip(switch_loop(parch, arr, words, sizes, keys), out):
        assert torch.equal(a, b)
    assert want.delivered_copies > 0 and want.drops > 0


def _multiword(dsl):
    """chip_smoke.py's multi-word header, built with one package's DSL."""
    return dsl.Protocol("multiword", [dsl.Field(n, b, semantic=sem)
                                      for n, b, sem in _chip_smoke().MULTIWORD_FIELDS])


#: the multi-word header on both tables, both VOQs and all three schedulers
MULTIWORD_CASES = [(ForwardTableKind.FULL_LOOKUP, VOQKind.NXN, SchedulerKind.ISLIP),
                   (ForwardTableKind.MULTIBANK_HASH, VOQKind.SHARED, SchedulerKind.EDRRM),
                   (ForwardTableKind.FULL_LOOKUP, VOQKind.SHARED, SchedulerKind.RR)]


def _multiword_inputs(fwd, voq, sched, device="cpu"):
    from repro.core import dsl as rdsl
    bound = bind(_multiword(rdsl), flit_bits=256)
    arch = _arch(fwd, voq, sched, 8, 2, depth=2)
    parch, pbound = convert.from_reference(arch), convert.from_reference(bound)
    trace = hft(seed=3, duration_s=2e-6)
    return (arch, bound, trace, parch,
            _loop_inputs(parch, pbound, convert.from_reference(trace), 500, device))


@pytest.mark.parametrize("fwd,voq,sched", MULTIWORD_CASES,
                         ids=lambda c: getattr(c, "value", c))
def test_ref_equals_reference_simulate_multiword(fwd, voq, sched):
    """Keys past word 0, the routing key across words 1 and 2: the plain
    loop, fed the header words, gives the reference's simulate exactly."""
    arch, bound, trace, parch, (prep, arr, words, sizes, keys) = _multiword_inputs(
        fwd, voq, sched)
    assert words.shape[1] == 3
    (route, src) = keys
    assert [w for w, *_ in route] == [1, 2] and [w for w, *_ in src] == [2]
    # hft's 8 ports: bit 2 of a destination lies in word 1, bits 1-0 in word 2
    assert route[0][3] == 2 and route[1][2] == 2
    want = ref_simulate(arch, bound, trace, fclk_hz=FCLK, max_cycles=500)
    out = switch_loop_ref(parch, arr, words, sizes, keys)
    _assert_sim_equal(sw.sim_result(parch, prep, out, FCLK), want)
    assert want.delivered_copies > 0
    # the same through simulate, which hands the loop the header words
    got = sw.simulate(parch, convert.from_reference(bound), convert.from_reference(trace),
                      fclk_hz=FCLK, max_cycles=500, device="cpu")
    _assert_sim_equal(got, want)


def test_key_pieces_pack_the_two_keys():
    from repro_torch.core import dsl as pdsl
    from repro_torch.core import bind as pbind, ethernet_ipv4_udp
    for proto in (_multiword(pdsl), ethernet_ipv4_udp()):
        b = pbind(proto, flit_bits=256)
        keys = slices(proto, [b.semantics["routing_key"], b.semantics["src_key"]]).baked
        kp = loop_kernel.key_pieces(keys)
        back = tuple(tuple((kp.word[f][j], kp.lo[f][j], int(kp.mask[f][j]).bit_length(),
                            kp.dst[f][j]) for j in range(2) if kp.mask[f][j])
                     for f in range(2))
        assert back == keys
        # a key of one piece: its second reads no word (mask 0)
        assert all(kp.mask[f][j] == 0 for f in range(2) for j in range(len(keys[f]), 2))
    assert ctypes.sizeof(loop_kernel.KeyPieces) == 64     # csrc/switch_loop.cu's
    piece = (0, 0, 4, 0)
    with pytest.raises(ValueError, match="two pieces"):
        loop_kernel.key_pieces(((piece,) * 3, (piece,)))
    with pytest.raises(ValueError, match="two pieces"):
        loop_kernel.key_pieces(((piece,),))


def _hook(kst, pids, out_port, valid, cyc):
    return kst, out_port, valid


def test_simulate_dispatches_on_the_architecture(monkeypatch):
    calls = {"ops": 0, "ref": 0}
    real_ops, real_ref = loop_ops.switch_loop, loop_ops.switch_loop_ref

    def spy_ops(*a):
        calls["ops"] += 1
        return real_ops(*a)

    def spy_ref(*a):
        calls["ref"] += 1
        return real_ref(*a)
    monkeypatch.setattr(loop_ops, "switch_loop", spy_ops)
    monkeypatch.setattr(loop_ops, "switch_loop_ref", spy_ref)
    bound, trace = _inputs(8)
    base = convert.from_reference(_arch(ForwardTableKind.FULL_LOOKUP, VOQKind.SHARED,
                                        SchedulerKind.ISLIP, 8, 2, depth=4))
    pbound, ptrace = convert.from_reference(bound), convert.from_reference(trace)
    plain = sw.simulate(base, pbound, ptrace, fclk_hz=FCLK, max_cycles=300, device="cpu")
    assert calls == {"ops": 1, "ref": 1}     # CPU tensors: the op's plain version
    # a Python hook runs in the eager loop, which is the op's CPU path
    hooked = dataclasses.replace(base, custom_kernels=(pa.CustomKernelSpec("id", fn=_hook),))
    got = sw.simulate(hooked, pbound, ptrace, fclk_hz=FCLK, max_cycles=300, device="cpu")
    assert calls == {"ops": 2, "ref": 2}
    # a custom kernel without fn is only a performance interface
    iface = dataclasses.replace(base, custom_kernels=(pa.CustomKernelSpec("iface"),))
    sw.simulate(iface, pbound, ptrace, fclk_hz=FCLK, max_cycles=300, device="cpu")
    assert calls == {"ops": 3, "ref": 3}
    # on a card: the fused launch without a hook; with one, the ingress
    # pass, the hook on the host, then the egress pass (the launches stood
    # in for by their plain versions, CPU tensors routed as a card's)
    _, arr, words, sizes, keys = _loop_inputs(base, pbound, ptrace, 100)
    launched = []

    def stand_in(name, fn):
        def run(*a):
            launched.append(name)
            return fn(*a)
        return run
    monkeypatch.setattr(loop_ops, "_plain", lambda x: False)
    monkeypatch.setattr(loop_kernel, "switch_loop_launch",
                        stand_in("fused", real_ref))
    monkeypatch.setattr(loop_kernel, "switch_ingress_launch",
                        stand_in("ingress", loop_ref.ingress_ref))
    monkeypatch.setattr(loop_kernel, "switch_egress_launch",
                        stand_in("egress", loop_ref.egress_ref))
    for arch, route in ((base, ["fused"]), (iface, ["fused"]),
                        (hooked, ["ingress", "egress"])):
        launched.clear()
        got_out = loop_ops.switch_loop(arch, arr, words, sizes, keys)
        assert launched == route
        for g, w in zip(got_out, real_ref(arch, arr, words, sizes, keys)):
            assert torch.equal(g, w)
    # the fused form cannot call the hook: its wrapper sends it to the passes
    monkeypatch.undo()
    with pytest.raises(ValueError, match="ingress"):
        loop_kernel.switch_loop_launch(hooked, arr, words, sizes, keys)
    # an identity hook changes nothing but the pipeline latency it adds
    assert got.delivered_copies == plain.delivered_copies
    np.testing.assert_array_equal(got.latency_cycles, plain.latency_cycles)
    np.testing.assert_array_equal(got.occ_trace, plain.occ_trace)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    bound, trace = _inputs(8)
    arch = convert.from_reference(_arch(ForwardTableKind.FULL_LOOKUP, VOQKind.NXN,
                                        SchedulerKind.RR, 8, 2))
    _, arr, words, sizes, keys = _loop_inputs(arch, convert.from_reference(bound),
                                              convert.from_reference(trace), 100)
    with pytest.raises(ValueError, match="CUDA"):
        loop_kernel.switch_loop_launch(arch, arr, words, sizes, keys)
    with pytest.raises(ValueError, match="1..32 ports"):
        loop_kernel.plan(dataclasses.replace(arch, n_ports=33), 10)
    with pytest.raises(ValueError, match="banks"):
        loop_kernel.plan(dataclasses.replace(arch, fwd=pa.ForwardTableKind.MULTIBANK_HASH,
                                             hash_banks=33), 10)
    with pytest.raises(ValueError, match="address bits"):
        loop_kernel.plan(dataclasses.replace(arch, addr_bits=31), 10)


def _port_arch(n, fwd, voq, sched, depth, addr_bits, bus=128):
    return pa.SwitchArch(n, bus, fwd, voq, sched, voq_depth=depth, addr_bits=addr_bits)


@pytest.mark.parametrize("name,arch,table_shared,ring_shared", [
    # hft's rung-4 champion, Full/NxN/RR@128b d288: ring 8 x 8 x 288 x 4 B
    ("hft", _port_arch(8, pa.ForwardTableKind.FULL_LOOKUP, pa.VOQKind.NXN,
                       pa.SchedulerKind.RR, 288, 4), True, True),
    # datacenter's, Full/NxN/ISLIP@1024b d36: ring 32 x 32 x 36 x 4 B
    ("datacenter", _port_arch(32, pa.ForwardTableKind.FULL_LOOKUP, pa.VOQKind.NXN,
                              pa.SchedulerKind.ISLIP, 36, 5, 1024), True, True),
    # the deepest queue at 32 ports: 8 MiB of ring
    ("deep", _port_arch(32, pa.ForwardTableKind.MULTIBANK_HASH, pa.VOQKind.SHARED,
                        pa.SchedulerKind.EDRRM, 2048, 32), True, False),
    # a 16-bit full table does not fit beside the counters either
    ("wide_table", _port_arch(32, pa.ForwardTableKind.FULL_LOOKUP, pa.VOQKind.NXN,
                              pa.SchedulerKind.RR, 2048, 16), False, False),
])
def test_plan_places_state(name, arch, table_shared, ring_shared):
    n, d = arch.n_ports, arch.voq_depth
    p = loop_kernel.plan(arch, 1000)
    assert (p.table_shared, p.ring_shared) == (table_shared, ring_shared)
    counters = 3 * n * (n + 1) * 4
    assert p.ring_words == n * n * d
    assert p.smem_bytes == (counters + 4 * p.table_words * table_shared
                            + 4 * p.ring_words * ring_shared)
    assert p.smem_bytes <= 232448
    if name == "hft":
        assert 4 * p.ring_words == 73728 and p.table_words == 16
    if name == "datacenter":
        assert 4 * p.ring_words == 147456 and p.table_words == 32


def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports the standard
    library only)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_forms_cover_the_kinds_and_placements():
    """The card's forms: every table x VOQ x scheduler kind, iSLIP's 1-4
    rounds at 32 ports, each placement plan() makes, and a main form at
    the shape hft's rung 4 gives the kernel (the fixture's cycle count)."""
    cs = _chip_smoke()
    forms = cs.switch_loop_forms("cpu")
    kinds = {(a.fwd, a.voq, a.sched) for a, *_ in forms.values()}
    assert len(kinds) == 12
    assert {a.islip_iters for a, *_ in forms.values()
            if a.n_ports == 32 and a.sched is pa.SchedulerKind.ISLIP} == {1, 2, 3, 4}
    places = {tuple(loop_kernel.plan(a, 1)[1:3]) for a, *_ in forms.values()}
    assert places == {(True, True), (True, False), (False, True)}
    arch, bound, trace, fclk, cycles = forms["hft_rung4_champion"]
    assert cycles is None and arch.short() == "Full/NxN/RR@128b d288"
    prep = sw.prepare_cycle_inputs(arch, bound, trace, fclk)
    fixture = pathlib.Path(__file__).resolve().parent / "torch_golden" / "hft_auto.json"
    want = json.loads(fixture.read_text())["escalated"]
    assert prep["arr_pid"].shape == (want["n_cycles"], 8)
    assert prep["header_words"].shape[0] == want["offered"]
    assert cs.KERNELS["switch_loop"]["main"][0] == "hft_rung4_champion"
    # the ingress parse's two-piece path: keys past word 0, one across two
    _, multi, *_ = forms["multiword_keys"]
    keys = slices(multi.protocol, [multi.semantics["routing_key"],
                                   multi.semantics["src_key"]]).baked
    assert max(map(len, keys)) == 2 and min(w for k in keys for w, *_ in k) > 0


# --------------------------------------------------------------------------
# on the card only
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_cuda_kernel_bitwise_vs_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    fwd, voq, sched, n, iters, cycles = case
    arch = convert.from_reference(_arch(fwd, voq, sched, n, iters,
                                        depth=1 if n == 8 else 2))
    bound, trace = _inputs(n)
    dev = torch.device("cuda")
    _, arr, words, sizes, keys = _loop_inputs(arch, convert.from_reference(bound),
                                              convert.from_reference(trace), cycles, dev)
    n0 = loop_kernel.LAUNCHES
    got = switch_loop(arch, arr, words, sizes, keys)
    torch.cuda.synchronize()
    assert loop_kernel.LAUNCHES == n0 + 1
    for g, w in zip(got, switch_loop_ref(arch, arr, words, sizes, keys)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("fwd,voq,sched", MULTIWORD_CASES,
                         ids=lambda c: getattr(c, "value", c))
def test_cuda_multiword_ingress_parse_bitwise_vs_plain(fwd, voq, sched):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    *_, parch, (_, arr, words, sizes, keys) = _multiword_inputs(
        fwd, voq, sched, torch.device("cuda"))
    got = switch_loop(parch, arr, words, sizes, keys)
    for g, w in zip(got, switch_loop_ref(parch, arr, words, sizes, keys)):
        assert torch.equal(g, w)
