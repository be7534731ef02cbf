"""The port's static-analysis layer (``repro_torch.analysis``) against the
JAX package's.

Contract: ``check_scenario`` gives the reference's ``Diagnostic`` records,
item for item, on every registry scenario and on the bad fixtures of
``tests/test_analysis.py``; ``lint_source``/``lint_paths`` give the
reference's findings on its lint snippets and on ``src/repro``, and none on
``src/repro_torch``; the retrace guard's deltas on the reference's call
sequence are the reference's (the port counts distinct call keys where jit
counts compiles); the CLI's ``check``/``lint`` exit 0 clean, 1 findings,
2 usage.
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import dataclasses  # noqa: E402
import os  # noqa: E402
import textwrap  # noqa: E402

import pytest  # noqa: E402

from repro.analysis import lint as ref_lint  # noqa: E402
from repro.analysis.check import check_scenario as ref_check  # noqa: E402
from repro.api import registry as ref_registry  # noqa: E402
from repro.api.scenario import TopologySpec as RefTopologySpec  # noqa: E402
from repro.core.dse import SLA as RefSLA, ResourceBudget as RefBudget  # noqa: E402

from repro_torch.analysis import lint as port_lint  # noqa: E402
from repro_torch.analysis import (Diagnostic, RetraceError, exit_code,  # noqa: E402
                                  retrace_guard, to_json_payload)
from repro_torch.analysis.check import check_scenario  # noqa: E402
from repro_torch.api import registry  # noqa: E402
from repro_torch.api.cli import main as cli_main  # noqa: E402
from repro_torch.api.scenario import TopologySpec  # noqa: E402
from repro_torch.core.dse import SLA, ResourceBudget  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: each package's (registry, SLA, ResourceBudget, TopologySpec)
REF = (ref_registry, RefSLA, RefBudget, RefTopologySpec)
PORT = (registry, SLA, ResourceBudget, TopologySpec)


def _with_protocol_params(scenario, **params):
    proto = dataclasses.replace(scenario.protocol,
                                params={**scenario.protocol.params, **params})
    return dataclasses.replace(scenario, protocol=proto)


def _widened(reg, name):
    base = reg[name]
    return dataclasses.replace(base, protocol=base.protocol.widen())


#: tests/test_analysis.py's bad (and healthy co-design) fixtures, built from
#: either package's classes
FIXTURES = {
    "underaddressed": lambda reg, sla, bud, topo: _with_protocol_params(
        reg["hft"], addr_bits=2),
    "sla_p99": lambda reg, sla, bud, topo: dataclasses.replace(
        reg["hft"], sla=sla(p99_latency_ns=1.0)),
    "sla_throughput": lambda reg, sla, bud, topo: dataclasses.replace(
        reg["hft"], sla=sla(min_throughput_gbps=1e6)),
    "overbudget": lambda reg, sla, bud, topo: dataclasses.replace(
        reg["hft"], budget=bud({"luts": 10.0, "gates": 1.0})),
    "dead_gene": lambda reg, sla, bud, topo: _with_protocol_params(
        _widened(reg, "datacenter"), addr_bits=(2, 4)),
    "codesign_info": lambda reg, sla, bud, topo: _widened(reg, "datacenter"),
    "fabric_k8": lambda reg, sla, bud, topo: dataclasses.replace(
        reg["fattree_dc"], name="bad_fabric",
        topology=topo.make("fattree", k=8)),
    "fabric_space_k8": lambda reg, sla, bud, topo: _with_protocol_params(
        dataclasses.replace(_widened(reg, "fattree_dc"),
                            name="bad_fabric_space",
                            topology=topo.make("fattree", k=8)),
        addr_bits=(2, 4)),
}


def _dicts(diags):
    return [d.to_dict() for d in diags]


# --------------------------------------------------------------------------
# check: the reference's diagnostics, item for item
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", registry.names())
def test_check_registry_matches_reference_and_is_clean(name):
    got = _dicts(check_scenario(registry[name]))
    assert got == _dicts(ref_check(ref_registry[name]))
    assert exit_code(check_scenario(registry[name])) == 0


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_check_bad_fixture_matches_reference(fixture):
    want = _dicts(ref_check(FIXTURES[fixture](*REF)))
    got = _dicts(check_scenario(FIXTURES[fixture](*PORT)))
    assert got == want
    assert got, "every fixture yields at least one diagnostic"


def test_check_fixture_codes():
    """The documented code of each fixture (tests/test_analysis.py)."""
    codes = {k: {d.code for d in check_scenario(f(*PORT))}
             for k, f in FIXTURES.items()}
    assert "SPAC101" in codes["underaddressed"]
    assert "SPAC102" in codes["sla_p99"] and "SPAC102" in codes["sla_throughput"]
    assert "SPAC103" in codes["overbudget"]
    assert {"SPAC104", "SPAC105"} <= codes["dead_gene"]
    assert codes["codesign_info"] == {"SPAC105"}
    assert "SPAC106" in codes["fabric_k8"] and "SPAC106" in codes["fabric_space_k8"]


def test_diagnostic_record_shape():
    d = Diagnostic("SPAC101", "error", "msg", "protocol.dst", hint="widen")
    assert d.to_dict() == {"code": "SPAC101", "severity": "error",
                           "message": "msg", "location": "protocol.dst",
                           "hint": "widen"}
    assert "hint: widen" in d.format()
    with pytest.raises(ValueError):
        Diagnostic("SPAC101", "fatal", "msg", "loc")
    payload = to_json_payload([d])
    assert payload["exit_code"] == 1 and payload["worst_severity"] == "error"


# --------------------------------------------------------------------------
# check CLI: exit codes 0 / 1 / 2
# --------------------------------------------------------------------------

def test_check_cli_clean_and_json(capsys):
    assert cli_main(["check", "hft", "grad_bucket"]) == 0
    assert "clean" in capsys.readouterr().out
    assert cli_main(["check", "hft", "--format", "json"]) == 0
    assert '"exit_code": 0' in capsys.readouterr().out


def test_check_cli_findings_from_fixture_file(tmp_path, capsys):
    path = tmp_path / "bad_hft.json"
    path.write_text(FIXTURES["underaddressed"](*PORT).to_json())
    assert cli_main(["check", str(path)]) == 1
    out = capsys.readouterr().out
    assert "SPAC101" in out and str(path) in out


def test_check_cli_usage_errors(tmp_path, capsys):
    assert cli_main(["check", "no_such_scenario"]) == 2
    assert "unknown scenario" in capsys.readouterr().err
    bad = tmp_path / "malformed.json"
    bad.write_text("{ not json")
    assert cli_main(["check", str(bad)]) == 2
    assert "cannot load" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        cli_main(["check", "hft", "--format", "yaml"])
    assert e.value.code == 2


# --------------------------------------------------------------------------
# lint: the reference's findings, item for item
# --------------------------------------------------------------------------

#: the lint snippets of tests/test_analysis.py (positive and clean ones)
SNIPPETS = {
    "parse_error": "def f(:\n",
    "pr3_default": """
        def run_netsim(arch, cfg: NetSimConfig = NetSimConfig()):
            return cfg
    """,
    "default_list": "def f(xs=[]): pass",
    "default_dict": "def f(m={}): pass",
    "default_set": "def f(*, s=set()): pass",
    "default_ok": "def f(t=(1, 2), fs=frozenset({1}), x=None): pass",
    "np_random": "import numpy as np\nx = np.random.rand(3)\n",
    "np_rng_ok": "import numpy as np\nrng = np.random.default_rng(0)\n",
    "wallclock": """
        import time
        def bench():
            t0 = time.time()
            work()
            return {"wall_s": time.time() - t0,
                    "wall_time_s": time.time() - t0}
    """,
    "wallclock_rate_ok": """
        import time
        def bench(n):
            t0 = time.time()
            return {"rows_per_sec": n / (time.time() - t0)}
    """,
    "wallclock_subscript": """
        import time
        def bench(rec):
            t0 = time.perf_counter()
            rec["elapsed"] = time.perf_counter() - t0
            rec["elapsed_time_s"] = time.perf_counter() - t0
    """,
    "set_loop": "for d in {1, 2, 3}:\n    use(d)\n",
    "set_list": "xs = list({f(d) for d in ds})\n",
    "set_sorted_ok": "for d in sorted({1, 2, 3}):\n    use(d)\n",
    "jit_global": """
        import jax
        STATE = {"k": 1}
        @jax.jit
        def f(x):
            return x + STATE["k"]
    """,
    "jit_global_ok": """
        import jax
        STATE = (1, 2)
        @jax.jit
        def f(x):
            return x + STATE[0]
    """,
    "x64_bare": "enable_x64()\n",
    "x64_config": "config.update('jax_enable_x64', True)\n",
    "x64_with_ok": "with enable_x64():\n    run()\n",
    "jit_loop": """
        import jax
        for i in range(3):
            f = jax.jit(lambda x: x + i)
    """,
    "jit_builder_ok": """
        import jax
        def build(i):
            return jax.jit(lambda x: x + i)
        for i in range(3):
            f = build(i)
    """,
    "sort_loop": """
        import numpy as np
        for b in range(8):
            ends = np.sort(dep[b])
    """,
    "sort_iter_ok": """
        import numpy as np
        for k in np.argsort(times, kind="stable"):
            use(k)
    """,
    "sort_hoisted_ok": """
        import numpy as np
        ends = np.sort(dep, axis=1)
        for b in range(8):
            use(ends[b])
    """,
    "sort_while": """
        import numpy as np
        while np.lexsort((a, b))[0] != 0:
            step()
    """,
    "suppressed": "def f(xs=[]):  # spaclint: disable=SPAC201\n    pass\n",
    "suppressed_bare": "def f(xs=[]):  # spaclint: disable\n    pass\n",
    "suppressed_wrong": "def f(xs=[]):  # spaclint: disable=SPAC204\n    pass\n",
    "torch_f64": """
        import torch
        def f(x):
            return torch.zeros(3, dtype=torch.float64) + x.double()
    """,
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_lint_snippet_matches_reference(name):
    src = textwrap.dedent(SNIPPETS[name])
    want = _dicts(ref_lint.lint_source(src, filename="fix.py"))
    assert _dicts(port_lint.lint_source(src, filename="fix.py")) == want
    if name.endswith("_ok") or name in ("suppressed", "suppressed_bare"):
        assert want == []
    for sel in ({"SPAC204"}, {"SPAC201", "SPAC208"}):
        assert _dicts(port_lint.lint_source(src, "fix.py", select=sel)) \
            == _dicts(ref_lint.lint_source(src, "fix.py", select=sel))


def test_lint_rule_catalogue_is_the_reference_s():
    assert {c: dataclasses.astuple(r) for c, r in port_lint.RULES.items()} \
        == {c: dataclasses.astuple(r) for c, r in ref_lint.RULES.items()}


def test_lint_reference_tree_matches_reference():
    path = os.path.join(REPO, "src", "repro")
    assert _dicts(port_lint.lint_paths([path])) == _dicts(ref_lint.lint_paths([path]))


def test_lint_port_is_clean():
    diags = port_lint.lint_paths([os.path.join(REPO, "src", "repro_torch")])
    assert diags == [], "\n".join(d.format() for d in diags)


def test_lint_cli_exit_codes(tmp_path, capsys):
    assert port_lint.main(["--list-rules"]) == 0
    assert "SPAC201" in capsys.readouterr().out
    assert port_lint.main(["--select", "SPAC999", str(tmp_path)]) == 2
    assert port_lint.main([str(tmp_path / "nope")]) == 2
    dirty = tmp_path / "dirty.py"
    dirty.write_text("def f(xs=[]):\n    pass\n")
    capsys.readouterr()
    assert port_lint.main([str(dirty)]) == 1
    assert "SPAC201" in capsys.readouterr().out
    assert cli_main(["lint", str(dirty), "--select", "SPAC204"]) == 0
    assert cli_main(["lint", str(dirty)]) == 1
    assert cli_main(["lint", "--list-rules"]) == 0


# --------------------------------------------------------------------------
# retrace guard: one call key per (shape, static arguments)
# --------------------------------------------------------------------------

def test_retrace_guard_single_device():
    """tests/test_analysis.py's sequence, on the CPU: the same deltas."""
    from repro_torch.core import (ArchRequest, bind, compressed_protocol,
                                  enumerate_candidates)
    from repro_torch.sim import run_netsim_batched, run_surrogate_batched
    from repro_torch.traces import hft

    bound = bind(compressed_protocol(addr_bits=4, length_bits=6),
                 flit_bits=256)
    cands = enumerate_candidates(ArchRequest(n_ports=8, addr_bits=4))[:3]
    # a duration no other test uses -> a fresh event-count shape
    tr = hft(seed=0, duration_s=6.7e-5)
    kw = dict(back_annotation=False, device="cpu")

    with retrace_guard(expect=1) as g:
        run_surrogate_batched(cands, bound, tr, **kw)
    assert g.deltas() == {"surrogate.engine": 1}
    with retrace_guard(expect=0):
        run_surrogate_batched(cands, bound, tr, **kw)
    with retrace_guard(expect=1):        # new batch size -> exactly one more
        run_surrogate_batched(cands[:2], bound, tr, **kw)

    with retrace_guard(expect=1) as g:
        run_netsim_batched(cands, bound, tr, **kw)
    assert g.deltas() == {"netsim.engine": 1}
    with retrace_guard(expect=0):
        run_netsim_batched(cands, bound, tr, **kw)
    # the fixed point's round 1 is tracked too, under the reference's name
    with retrace_guard(expect=1) as g:
        run_netsim_batched(cands, bound, tr, use_kernel="on", **kw)
    assert g.deltas() == {"netsim.kernel.round1": 1}


def test_retrace_guard_raises_on_mismatch():
    with pytest.raises(RetraceError, match="expected exactly 3"):
        with retrace_guard(expect=3):
            pass


def test_tracked_wrapper_keys_static_values_and_shapes():
    import numpy as np
    import torch
    from repro_torch.analysis.retrace import compile_counts, track

    def f(x, y, *, n):
        return x

    g = track("test.f", f, static_argnames=("n",))
    with retrace_guard() as guard:
        g(torch.zeros(2, 3), 1.5, n=4)
        g(torch.ones(2, 3), 2.5, n=4)            # same key: values differ
        g(torch.zeros(2, 3, dtype=torch.float64), 1.5, n=4)  # dtype
        g(np.zeros((2, 3)), 1.5, n=4)            # an array
        g(np.ones((2, 3)), 0.5, n=4)             # the same array key
        g(torch.zeros(2, 3), 1.5, n=5)           # static value
        g(torch.zeros(2, 3), None, n=4)          # another argument type
    assert guard.deltas() == {"test.f": 5}
    assert compile_counts()["test.f"] == 5


def test_call_counts_count_each_keys_calls():
    """``call_counts`` shows which keys a region called, new or not: the
    served path reads the stage-2 engine's widths from it."""
    import torch
    from repro_torch.analysis.retrace import call_counts, track

    g = track("test.calls", lambda x, *, n: x, static_argnames=("n",))
    g(torch.zeros(4, 3), n=1)
    before = call_counts("test.calls")
    g(torch.zeros(4, 3), n=1)                    # an old key, called again
    g(torch.zeros(8, 3), n=1)
    after = call_counts("test.calls")
    key4 = (("x", ((4, 3), "torch.float32", "cpu")), ("n", 1))
    key8 = (("x", ((8, 3), "torch.float32", "cpu")), ("n", 1))
    assert before == {key4: 1}
    assert after == {key4: 2, key8: 1}
    before[key4] += 1                            # a copy: the record stays
    assert call_counts("test.calls")[key4] == 2
