"""The port's checkpoints (``repro_torch.checkpoint``) and search resume
against the JAX package's.

Contract: the port's store writes the reference's on-disk format byte for
byte (``manifest.json`` and one ``.npy`` a leaf, in ``jax.tree.flatten``'s
order), so a checkpoint either package writes restores in the other; a
bfloat16 leaf round-trips bitwise without ``ml_dtypes``; a generational
search stopped and resumed equals the uninterrupted one bitwise (front,
``hv_history``, next RNG draws), in the port and across the packages in
both directions; ``remesh_search_state`` is the identity on the arrays;
the CLI's ``run --checkpoint-dir`` then ``--resume`` gives the same report.
"""

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import collections  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import store as ref_store  # noqa: E402
from repro.core import (ArchRequest as RefArchRequest, bind as ref_bind,  # noqa: E402
                        compressed_protocol as ref_compressed)
from repro.core import SLA as RefSLA  # noqa: E402
from repro.core.search import SearchSpec as RefSearchSpec  # noqa: E402
from repro.core.search import run_search as ref_run_search  # noqa: E402
from repro.sim.switch_problem import SwitchDSEProblem as RefProblem  # noqa: E402
from repro.traces import hft as ref_hft  # noqa: E402

from repro_torch.api.scenario import MeshSpec  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.core import (ArchRequest, ResourceBudget, SLA, bind,  # noqa: E402
                              compressed_protocol, run_dse)
from repro_torch.core.search import (DesignSpace, Dim, NSGA2Search,  # noqa: E402
                                     SearchDriver, SearchSpec,
                                     load_search_state, remesh_search_state,
                                     run_search, save_search_state)
from repro_torch.sim.resources import ALVEO_U45N  # noqa: E402
from repro_torch.sim.switch_problem import SwitchDSEProblem  # noqa: E402
from repro_torch.traces import hft  # noqa: E402

BOUND = bind(compressed_protocol(addr_bits=4, length_bits=6), flit_bits=256)
REF_BOUND = ref_bind(ref_compressed(addr_bits=4, length_bits=6), flit_bits=256)
SLA_HFT = SLA(p99_latency_ns=5000, drop_rate=1e-3)
REF_SLA_HFT = RefSLA(p99_latency_ns=5000, drop_rate=1e-3)
BUDGET = ResourceBudget(dict(ALVEO_U45N))


def _problem(duration_s=8e-5, **kw):
    return SwitchDSEProblem(ArchRequest(n_ports=8, addr_bits=4), BOUND,
                            hft(seed=0, duration_s=duration_s),
                            back_annotation=False, device="cpu", **kw)


def _ref_problem(duration_s=8e-5):
    return RefProblem(RefArchRequest(n_ports=8, addr_bits=4), REF_BOUND,
                      ref_hft(seed=0, duration_s=duration_s),
                      back_annotation=False)


def _shorts(valid):
    return [c.short() for c, _ in valid]


def _tree():
    """A nested tree of every dtype the search state and a model hold."""
    rng = np.random.default_rng(3)
    return {
        "z": [np.arange(6, dtype=np.int64).reshape(2, 3), None,
              (rng.random(4), np.float32(2.5))],
        "a": {"flag": rng.random(5) < 0.5, "i32": np.int32(-7),
              "f32": rng.random((3, 2)).astype(np.float32)},
        "m": 3,
    }


def _bf16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


# --------------------------------------------------------------------------
# the store
# --------------------------------------------------------------------------

def test_store_roundtrip_every_dtype_bf16_bitwise(tmp_path):
    bf = torch.tensor(np.random.default_rng(0).standard_normal((3, 5)),
                      dtype=torch.float32).to(torch.bfloat16)
    tree = dict(_tree(), bf=bf, t64=torch.arange(4, dtype=torch.int64))
    store.save(str(tmp_path), 7, tree, extra={"k": [1, 2]})
    got, manifest = store.restore(str(tmp_path), template=tree)
    assert manifest["step"] == 7 and manifest["extra"] == {"k": [1, 2]}
    assert got["bf"].dtype == torch.bfloat16
    assert torch.equal(got["bf"].view(torch.int16), bf.view(torch.int16))
    assert torch.equal(got["t64"], tree["t64"])
    for a, b in zip(jax.tree.leaves(got["z"]), jax.tree.leaves(tree["z"])):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert got["z"][1] is None and isinstance(got["z"][2], tuple)
    assert got["a"]["flag"].dtype == np.bool_
    assert int(got["m"]) == 3


def test_store_files_equal_the_reference_s(tmp_path):
    """Same nested tree (bf16 included) -> the same manifest and .npy bytes."""
    vals = np.random.default_rng(1).standard_normal((2, 4)).astype(np.float32)
    ref_tree = dict(_tree(), bf=jnp.asarray(vals, jnp.bfloat16))
    port_tree = dict(_tree(), bf=torch.tensor(vals).to(torch.bfloat16))
    a = ref_store.save(str(tmp_path / "ref"), 3, ref_tree, extra={"x": 1.5})
    b = store.save(str(tmp_path / "port"), 3, port_tree, extra={"x": 1.5})
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    # the leaf order is jax.tree.flatten's
    assert len(jax.tree.leaves(ref_tree)) == json.load(
        open(os.path.join(b, "manifest.json")))["n_leaves"]


def test_reference_checkpoint_restores_in_port_and_back(tmp_path):
    vals = np.random.default_rng(2).standard_normal(6).astype(np.float32)
    ref_tree = dict(_tree(), bf=jnp.asarray(vals, jnp.bfloat16))
    ref_store.save(str(tmp_path / "r"), 1, ref_tree)
    port_tmpl = dict(_tree(), bf=torch.zeros(6, dtype=torch.bfloat16))
    got, _ = store.restore(str(tmp_path / "r"), template=port_tmpl)
    np.testing.assert_array_equal(_bf16_bits(got["bf"]), _bf16_bits(ref_tree["bf"]))
    for a, b in zip(jax.tree.leaves(got["z"]), jax.tree.leaves(ref_tree["z"])):
        np.testing.assert_array_equal(a, b)
    # the reverse: the port writes, the reference restores (through ml_dtypes)
    store.save(str(tmp_path / "p"), 2, got)
    back, _ = ref_store.restore(str(tmp_path / "p"), template=ref_tree)
    assert str(back["bf"].dtype) == "bfloat16"
    np.testing.assert_array_equal(_bf16_bits(back["bf"]), _bf16_bits(ref_tree["bf"]))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_places_template_tensors_and_checks_structure(tmp_path):
    tree = {"w": torch.arange(3.0), "n": np.arange(2)}
    store.save(str(tmp_path), 0, tree)
    got, _ = store.restore(str(tmp_path), template=tree, device="cpu")
    assert isinstance(got["w"], torch.Tensor) and torch.equal(got["w"], tree["w"])
    assert isinstance(got["n"], np.ndarray)
    with pytest.raises(ValueError, match="template"):
        store.restore(str(tmp_path))
    with pytest.raises(ValueError, match="leaves"):
        store.restore(str(tmp_path), template={"w": 0})
    with pytest.raises(FileNotFoundError):
        store.restore(str(tmp_path / "empty"), template=tree)


def test_flatten_order_is_jax_tree_flatten_s():
    Pt = collections.namedtuple("Pt", "y x")
    tree = {"b": [1, None, (2, 3)], "a": Pt(4, {"d": 5, "c": 6}),
            "o": collections.OrderedDict([("z", 7), ("y", 8)])}
    leaves, treedef = store._flatten(tree)
    assert leaves == jax.tree.leaves(tree)
    assert store._unflatten(treedef, leaves) == tree


def test_latest_step_ignores_tmp_and_stray_entries(tmp_path):
    d = str(tmp_path)
    assert store.latest_step(d) is None
    store.save(d, 4, {"a": np.zeros(1)})
    store.save(d, 12, {"a": np.zeros(1)})
    for stray in ("step_00000099.tmp", "step_backup", "notes", "step_"):
        os.makedirs(os.path.join(d, stray))
    assert store.latest_step(d) == 12
    assert store.latest_step(d) == ref_store.latest_step(d)


def test_async_checkpointer_keeps_newest_and_snapshots_now(tmp_path):
    ck = store.AsyncCheckpointer(str(tmp_path), keep=3)
    w = torch.zeros(4)
    for step in range(6):
        w += 1                        # mutated after each save: the snapshot holds
        ck.save_async(step, {"w": w, "step": np.int64(step)})
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:08d}" for s in (3, 4, 5)]
    for step in (3, 4, 5):
        got, _ = store.restore(str(tmp_path), step, template={"w": w, "step": 0})
        assert torch.equal(got["w"], torch.full((4,), float(step + 1)))


# --------------------------------------------------------------------------
# search resume (tests/test_search.py:197-260)
# --------------------------------------------------------------------------

def test_resume_matches_uninterrupted(tmp_path):
    spec = SearchSpec(population=16, generations=6, seed=4, patience=100)
    full = run_search(_problem(), spec, SLA_HFT)
    ck = str(tmp_path / "ck")
    part = run_search(_problem(), spec, SLA_HFT, checkpoint_dir=ck,
                      max_generations_this_run=2)
    assert part.generations == 2                # genuinely interrupted
    resumed = run_search(_problem(), spec, SLA_HFT, checkpoint_dir=ck,
                         resume=True)
    assert resumed.resumed
    assert resumed.generations == full.generations
    assert _shorts(resumed.valid) == _shorts(full.valid)
    assert resumed.hv_history == full.hv_history
    res_full = run_dse(_problem(), SLA_HFT, BUDGET, search=spec, top_k=3)
    res_res = run_dse(_problem(), SLA_HFT, BUDGET, search=spec, top_k=3,
                      checkpoint_dir=ck, resume=True)
    assert res_full.best == res_res.best
    assert [a.short() for a, _ in res_full.pareto] \
        == [a.short() for a, _ in res_res.pareto]


def test_checkpoint_roundtrip_restores_rng_state_exactly(tmp_path):
    spec = SearchSpec(population=12, generations=5, seed=8, patience=100)
    prob = _problem()
    driver = SearchDriver(prob, spec, SLA_HFT)
    for _ in range(2):
        driver.tell_candidates(prob.surrogate_batch(driver.ask_candidates()))
    ck = str(tmp_path / "ck")
    save_search_state(ck, driver.engine)
    eng = load_search_state(ck, prob.space(), spec)
    assert eng.rng.bit_generator.state == driver.engine.rng.bit_generator.state
    assert eng.rng.integers(1 << 30, size=8).tolist() \
        == driver.engine.rng.integers(1 << 30, size=8).tolist()
    assert eng.parents == driver.engine.parents
    assert eng.pending == driver.engine.pending
    assert eng.cache == driver.engine.cache
    assert eng.hv_history == driver.engine.hv_history
    assert eng.ref == driver.engine.ref


def test_resume_warns_when_checkpoint_dir_is_empty(tmp_path):
    spec = SearchSpec(population=8, generations=1, seed=0)
    with pytest.warns(RuntimeWarning, match="no search checkpoint"):
        out = run_search(_problem(), spec, SLA_HFT,
                         checkpoint_dir=str(tmp_path / "nope"), resume=True)
    assert not out.resumed


def test_resume_validates_spec_and_space(tmp_path):
    spec = SearchSpec(population=12, generations=4, seed=1)
    prob = _problem()
    ck = str(tmp_path / "ck")
    run_search(prob, spec, SLA_HFT, checkpoint_dir=ck,
               max_generations_this_run=1)
    with pytest.raises(ValueError, match="SearchSpec differs"):
        load_search_state(ck, prob.space(), dataclasses.replace(spec, seed=2))
    other = SwitchDSEProblem(
        ArchRequest(n_ports=8, addr_bits=4, bus_bits=256), BOUND,
        hft(seed=0, duration_s=8e-5), back_annotation=False, device="cpu")
    with pytest.raises(ValueError, match="design space differs"):
        load_search_state(ck, other.space(), spec)


# --------------------------------------------------------------------------
# resume across the packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cross_package_resume_is_bitwise(tmp_path, writer):
    """One package runs 2 generations to a checkpoint, the other resumes it
    to the end: the front and hv history equal the reference's
    uninterrupted run bitwise, and the resumed engines' RNG states agree."""
    kw = dict(population=16, generations=6, seed=4, patience=100)
    spec, ref_spec = SearchSpec(**kw), RefSearchSpec(**kw)
    full = ref_run_search(_ref_problem(), ref_spec, REF_SLA_HFT)
    ck = str(tmp_path / "ck")
    if writer == "reference":
        ref_run_search(_ref_problem(), ref_spec, REF_SLA_HFT,
                       checkpoint_dir=ck, max_generations_this_run=2)
        resumed = run_search(_problem(), spec, SLA_HFT, checkpoint_dir=ck,
                             resume=True)
    else:
        run_search(_problem(), spec, SLA_HFT, checkpoint_dir=ck,
                   max_generations_this_run=2)
        resumed = ref_run_search(_ref_problem(), ref_spec, REF_SLA_HFT,
                                 checkpoint_dir=ck, resume=True)
    assert resumed.resumed and resumed.generations == full.generations
    assert _shorts(resumed.valid) == _shorts(full.valid)
    assert resumed.hv_history == full.hv_history
    # the final checkpoint (written by the resuming package) equals what
    # the reference writes on an uninterrupted run, leaf for leaf
    ck_full = str(tmp_path / "full")
    ref_run_search(_ref_problem(), ref_spec, REF_SLA_HFT, checkpoint_dir=ck_full)
    step = store.latest_step(ck)
    assert step == ref_store.latest_step(ck_full)
    tmpl = {k: np.zeros((0,), np.int64) for k in NSGA2Search._STATE_KEYS}
    a, ma = store.restore(ck, step, template=tmpl)
    b, mb = store.restore(ck_full, step, template=tmpl)
    assert ma == mb
    for k in tmpl:
        np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------
# remesh: the identity on the arrays (tests/test_mesh_properties.py:133)
# --------------------------------------------------------------------------

def _searched_state(generations=3):
    space = DesignSpace((Dim("a", (1, 2, 3, 4)), Dim("b", (8, 16, 32))))
    eng = NSGA2Search(space, SearchSpec(population=8, generations=generations,
                                        seed=11))
    while not eng.done:
        asked = eng.ask()
        eng.tell({g: ((float(sum(g)), float(g[0] * g[1])), 0.0)
                  for g in asked})
    return eng


def _assert_state_equal(a, b, *, compare_mesh=True):
    tree_a, extra_a = a
    tree_b, extra_b = b
    assert sorted(tree_a) == sorted(tree_b)
    for key in tree_a:
        np.testing.assert_array_equal(tree_a[key], tree_b[key])
    if not compare_mesh:
        extra_a = {k: v for k, v in extra_a.items() if k != "mesh"}
        extra_b = {k: v for k, v in extra_b.items() if k != "mesh"}
    assert extra_a == extra_b


@pytest.mark.parametrize("n,m", [(1, 1), (1, 4), (8, 2), (3, 64), (64, 7)])
def test_remesh_roundtrip_identity(n, m):
    eng = _searched_state()
    tree, extra = eng.state()
    start = remesh_search_state(tree, extra, MeshSpec(devices=n))
    assert start[1]["mesh"] == {"devices": n, "scenario_axis": 1}
    via_m = remesh_search_state(*start, MeshSpec(devices=m))
    back = remesh_search_state(*via_m, MeshSpec(devices=n))
    _assert_state_equal(back, start)                      # N -> M -> N
    _assert_state_equal(via_m, start, compare_mesh=False)  # arrays never move
    restored = NSGA2Search.from_state(eng.space, eng.spec, *back)
    assert restored.archive() == eng.archive()
    assert restored.hv_history == eng.hv_history
    np.testing.assert_array_equal(restored.rng.random(16), eng.rng.random(16))
    bare = remesh_search_state(tree, extra, None)
    assert "mesh" not in bare[1]
    _assert_state_equal(bare, (tree, extra), compare_mesh=False)


def test_save_stamps_mesh_and_load_ignores_it(tmp_path):
    eng = _searched_state()
    save_search_state(str(tmp_path), eng, mesh=MeshSpec(devices=4))
    with open(tmp_path / f"step_{eng.generation:08d}" / "manifest.json") as f:
        assert json.load(f)["extra"]["mesh"] == {"devices": 4, "scenario_axis": 1}
    back = load_search_state(str(tmp_path), eng.space, eng.spec)
    assert back.archive() == eng.archive()


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def test_cli_run_checkpoint_then_resume(tmp_path, capsys):
    from repro_torch.api.cli import main
    from repro_torch.api.service import strip_times
    ck = str(tmp_path / "ck")
    args = ["run", "hft", "--search", "nsga2", "--generations", "3",
            "--population", "8", "--search-seed", "0", "--duration-s", "8e-05",
            "--no-back-annotation", "--top-k", "2", "--device", "cpu",
            "--checkpoint-dir", ck]
    assert main(args + ["--out", str(tmp_path / "a.json")]) == 0
    assert store.latest_step(ck) == 3
    assert main(args + ["--resume", "--out", str(tmp_path / "b.json")]) == 0
    capsys.readouterr()
    a = json.loads((tmp_path / "a.json").read_text())
    b = json.loads((tmp_path / "b.json").read_text())
    notes = [st["notes"] for st in (a["stages"][0], b["stages"][0])]
    assert "resumed=False" in notes[0] and "resumed=True" in notes[1]
    a["stages"][0]["notes"] = b["stages"][0]["notes"] = None
    assert strip_times(a) == strip_times(b)
    assert main(["sweep", "hft", "--search", "nsga2", "--generations", "2",
                 "--population", "8", "--duration-s", "8e-05",
                 "--no-back-annotation", "--top-k", "2", "--device", "cpu",
                 "--checkpoint-dir", ck, "--resume"]) == 0


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_checkpoint_and_resume_bitwise(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")

    def prob():
        return SwitchDSEProblem(ArchRequest(n_ports=8, addr_bits=4), BOUND,
                                hft(seed=0, duration_s=8e-5),
                                back_annotation=False, device="cuda")
    spec = SearchSpec(population=16, generations=6, seed=4, patience=100)
    full = run_search(prob(), spec, SLA_HFT)
    ck = str(tmp_path / "ck")
    run_search(prob(), spec, SLA_HFT, checkpoint_dir=ck,
               max_generations_this_run=2)
    resumed = run_search(prob(), spec, SLA_HFT, checkpoint_dir=ck, resume=True)
    assert _shorts(resumed.valid) == _shorts(full.valid)
    assert resumed.hv_history == full.hv_history
    assert _shorts(full.valid) == _shorts(run_search(_problem(), spec, SLA_HFT).valid)
    w = torch.randn(64, device="cuda").to(torch.bfloat16)
    store.save(str(tmp_path / "t"), 0, {"w": w})
    got, _ = store.restore(str(tmp_path / "t"), template={"w": w})
    assert got["w"].device == w.device
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
