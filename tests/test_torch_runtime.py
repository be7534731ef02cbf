"""The port's training runtime (``repro_torch.runtime``: the fault-tolerant
``Supervisor``, ``StragglerWatch``, elastic ``remesh``; the optimizers, the
LR schedule, the data pipeline and the train step; the int8 pod-gradient
protocol) against the JAX package's.

Contract, on the CPU at smoke size (llama3.2-1b, weights from the NumPy
seed in both packages):

- three AdamW and three Adafactor train steps from the same params and
  state (``convert.opt_state``): every loss within 1e-5 relative, the
  gradient norm within 1e-4 relative, the lr bitwise, every parameter
  within 2e-2 of its largest |p| (bfloat16 weights: one bfloat16 ulp of an
  updated weight is 4e-3 relative, and a near-zero gradient's sign flips
  AdamW's first steps), the optimizer state within 1e-3 of its largest
  entry; microbatches 1 against 2 within the reference's 5e-2;
  ``lr_schedule`` and ``SyntheticLM`` bitwise;
- the supervisor: crashes injected at steps 7 and 15 of 20 (checkpoints
  every 5) end at step 20 after 2 restarts with step 5 replayed;
  ``StragglerWatch`` fires on the slow step only;
- ``remesh`` moves a state bitwise and refuses a zero-extent axis and a
  mesh larger than the devices, with the reference's messages;
- a checkpoint the reference's ``Supervisor`` wrote resumes in the port's,
  whose next step matches the reference's next step;
- the int8 pod-gradient protocol on a 2-pod mesh (the reference in a
  subprocess with 2 forced host devices, the port with
  ``REPRO_TORCH_FORCE_DEVICE_COUNT=2``): loss within 1e-5 relative, the
  compressed gradient's norm within 1e-3, parameters after one step as the
  train steps above; the bf16 payload gives the full batch's gradient.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import data as ref_data  # noqa: E402
from repro import runtime as ref_runtime  # noqa: E402
from repro import train as ref_train  # noqa: E402
from repro.models import SINGLE_POD_PLAN as REF_PLAN  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import data as port_data  # noqa: E402
from repro_torch import runtime as port_runtime  # noqa: E402
from repro_torch import train as port_train  # noqa: E402
from repro_torch.checkpoint import restore as port_restore  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch.mesh import FORCE_ENV, compat_make_mesh, plan_for_mesh  # noqa: E402
from repro_torch.models import SINGLE_POD_PLAN  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

from test_torch_train import _both, _f32_arrays, _flat, _leaf_dists, _np  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests' tensors are small: one intra-op thread a test process
    (the suite runs several processes at once; restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# optimizers, schedule, data, train step
# --------------------------------------------------------------------------

def _train_both(opt_name, steps=3, mb=1, seed=0):
    """``steps`` train steps of both packages from the same params and
    state: (ref losses, port losses, ref (params, state), port (params,
    state))."""
    from repro.launch.mesh import compat_make_mesh
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    rc, pc, rp, pp = _both("llama3.2-1b", "float32", seed)
    spec_kw = dict(lr=1e-3, warmup_steps=2, total_steps=10, microbatches=mb)
    r_opt = (ref_train.adamw(lr=1e-3) if opt_name == "adamw"
             else ref_train.adafactor(lr=3e-3))
    p_opt = (port_train.adamw(lr=1e-3) if opt_name == "adamw"
             else port_train.adafactor(lr=3e-3))
    r_state = r_opt.init(rp)
    p_state = convert.opt_state(jax.tree.map(np.asarray, r_state), "cpu")
    r_step = jax.jit(ref_train.make_train_step(rc, REF_PLAN, mesh, r_opt,
                                               ref_train.TrainSpec(**spec_kw)))
    p_step = port_train.make_train_step(pc, SINGLE_POD_PLAN, None, p_opt,
                                        port_train.TrainSpec(**spec_kw))
    data = port_data.SyntheticLM(port_data.DataConfig(vocab=pc.vocab, seq_len=32,
                                                      global_batch=4, seed=seed))
    r_losses, p_losses = [], []
    for step in range(steps):
        batch = data.batch(step)
        rp, r_state, rm = r_step(rp, r_state, {k: jnp.asarray(v) for k, v in batch.items()},
                                 jnp.asarray(step))
        pp, p_state, pm = p_step(pp, p_state, batch, step)
        r_losses.append(float(rm["loss"]))
        p_losses.append(float(pm["loss"]))
        assert sorted(pm) == sorted(rm)
        assert float(pm["lr"]) == float(rm["lr"])
        assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= 1e-4 * float(rm["grad_norm"])
    return r_losses, p_losses, (rp, r_state), (pp, p_state)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_three_steps_match_reference(opt_name):
    r_losses, p_losses, (rp, rs), (pp, ps) = _train_both(opt_name)
    np.testing.assert_allclose(p_losses, r_losses, rtol=1e-5)
    dists = _leaf_dists(pp, rp)
    assert max(dists.values()) <= 2e-2, dists
    state_dists = _leaf_dists({k: v for k, v in ps.items() if k != "count"},
                              {k: v for k, v in rs.items() if k != "count"})
    assert max(state_dists.values()) <= 1e-3, state_dists
    assert int(ps["count"]) == int(rs["count"]) == 3 and ps["count"].dtype == torch.int32


def test_microbatches_give_the_same_update():
    """The reference's mb=1 vs mb=2 check (5e-2), and mb=2 against the
    reference's mb=2."""
    _, _, _, (p1, _) = _train_both("adamw", steps=1, mb=1)
    r2, p2_losses, (rp2, _), (p2, _) = _train_both("adamw", steps=1, mb=2)
    assert max(float(np.abs(_np(a) - _np(_flat(p2)[k])).max())
               for k, a in _flat(p1).items()) < 5e-2
    assert max(_leaf_dists(p2, rp2).values()) <= 2e-2
    np.testing.assert_allclose(p2_losses, r2, rtol=1e-5)


@pytest.mark.parametrize("schedule", ["wsd", "cosine", "const"])
def test_lr_schedule_bitwise(schedule):
    for warm, total in ((10, 100), (7, 1000), (1, 13)):
        rs = ref_train.TrainSpec(lr=3e-4, warmup_steps=warm, total_steps=total,
                                 schedule=schedule)
        ps = port_train.TrainSpec(lr=3e-4, warmup_steps=warm, total_steps=total,
                                  schedule=schedule)
        for step in sorted({0, 1, warm - 1, warm, total // 2, int(0.9 * total),
                            int(0.95 * total), total - 1, total, total + 5}):
            want = np.float32(ref_train.lr_schedule(rs, jnp.asarray(step)))
            got = port_train.lr_schedule(ps, step)
            assert got.dtype == torch.float32
            assert np.float32(got.item()).view(np.uint32) == want.view(np.uint32), \
                (schedule, warm, total, step)


@pytest.mark.parametrize("frontend", ["tokens", "embeddings", "mrope"])
def test_synthetic_lm_bitwise(frontend):
    kw = dict(vocab=97, seq_len=24, global_batch=3, seed=5,
              frontend="tokens" if frontend == "tokens" else "embeddings",
              d_model=16, mrope=frontend == "mrope")
    r, p = ref_data.SyntheticLM(ref_data.DataConfig(**kw)), \
        port_data.SyntheticLM(port_data.DataConfig(**kw))
    for step in (0, 13, 14):
        rb, pb = r.batch(step), p.batch(step)
        assert sorted(rb) == sorted(pb)
        for k in rb:
            assert rb[k].dtype == pb[k].dtype
            np.testing.assert_array_equal(pb[k], rb[k])
    cfg = get_smoke("qwen2-vl-72b")
    shape = type("Shape", (), {"seq_len": 8, "global_batch": 2})()
    for k, v in ref_data.make_batch_for_shape(cfg, shape, seed=1).items():
        np.testing.assert_array_equal(port_data.make_batch_for_shape(cfg, shape, seed=1)[k], v)


def test_train_steps_reduce_loss_and_clip():
    """The reference's test_loss_decreases_adamw on the port."""
    pc = get_smoke("llama3.2-1b")
    params = PT.init_params(torch.Generator("cpu").manual_seed(0), pc, SINGLE_POD_PLAN)
    opt = port_train.adamw(lr=1e-3)
    step = port_train.make_train_step(pc, SINGLE_POD_PLAN, None, opt,
                                      port_train.TrainSpec(lr=1e-3, warmup_steps=5,
                                                           total_steps=30))
    data = port_data.SyntheticLM(port_data.DataConfig(vocab=pc.vocab, seq_len=64,
                                                      global_batch=4))
    state, losses = opt.init(params), []
    for i in range(30):
        params, state, m = step(params, state, data.batch(i), i)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3
    grads = {"a": torch.full((3,), 4.0), "b": {"c": torch.full((4,), 3.0)}}
    clipped, gn = port_train.clip_by_global_norm(grads, 1.0)
    assert float(gn) == pytest.approx(np.sqrt(3 * 16 + 4 * 9))
    assert float(port_train.clip_by_global_norm(clipped, 1.0)[1]) == pytest.approx(1.0)


# --------------------------------------------------------------------------
# supervisor, straggler watch, remesh
# --------------------------------------------------------------------------

def _port_setup(seed=0):
    _, pc, _, pp = _both("llama3.2-1b", "float32", seed)
    opt = port_train.adamw(lr=1e-3)
    step = port_train.make_train_step(pc, SINGLE_POD_PLAN, None, opt,
                                      port_train.TrainSpec(lr=1e-3, warmup_steps=2,
                                                           total_steps=30))
    data = port_data.SyntheticLM(port_data.DataConfig(vocab=pc.vocab, seq_len=32,
                                                      global_batch=2))

    def step_fn(state, i):
        p, o = state
        p, o, m = step(p, o, data.batch(i), i)
        return (p, o), m
    return pp, opt, step_fn


def test_supervisor_restart_resumes_training(tmp_path):
    pp, opt, step_fn = _port_setup()
    inj = port_runtime.FaultInjector(schedule={7: "crash", 15: "crash"})
    sup = port_runtime.Supervisor(str(tmp_path), ckpt_every=5, injector=inj)
    res = sup.run((pp, opt.init(pp)), step_fn, total_steps=20)
    assert res.final_step == 20 and res.restarts == 2
    steps = [h["step"] for h in res.metrics_history]
    assert steps.count(5) >= 2                       # replayed after the crash at 7
    assert inj.fired == [7, 15]
    assert all(np.isfinite(h["loss"]) for h in res.metrics_history)
    # a crash past max_restarts propagates
    sup = port_runtime.Supervisor(str(tmp_path / "b"), ckpt_every=5, max_restarts=0,
                                  injector=port_runtime.FaultInjector({1: "crash"}))
    with pytest.raises(port_runtime.NodeFailure):
        sup.run((pp, opt.init(pp)), step_fn, total_steps=3)


def test_straggler_watch_fires():
    for mod in (ref_runtime, port_runtime):
        w = mod.StragglerWatch(deadline_multiple=2.0)
        fired = []
        for step, dt in enumerate([1.0, 1.0, 1.0, 5.0, 1.0]):
            w.observe(step, dt, on_straggler=lambda s, d, e: fired.append(s))
        assert fired == [3] and len(w.events) == 1
    pw, rw = port_runtime.StragglerWatch(), ref_runtime.StragglerWatch()
    for step, dt in enumerate([0.3, 0.2, 1.7, 0.25, 0.9, 3.0, 0.2]):
        assert pw.observe(step, dt) == rw.observe(step, dt)
    assert pw.events == rw.events


def test_elastic_remesh_roundtrip(monkeypatch):
    pp, opt, _ = _port_setup()
    state = (pp, opt.init(pp))
    specs = (PT.param_specs(get_smoke("llama3.2-1b"), SINGLE_POD_PLAN),
             opt.state_specs(PT.param_specs(get_smoke("llama3.2-1b"), SINGLE_POD_PLAN)))
    mesh = compat_make_mesh((1, 1), ("data", "model"), "cpu")
    moved = port_runtime.remesh(state, specs, mesh)
    a, b = port_train.optimizer.tree_leaves(state), port_train.optimizer.tree_leaves(moved)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y) and x.dtype == y.dtype and x.data_ptr() != y.data_ptr()
    assert port_runtime.scaled_microbatches(2, old_dp=16, new_dp=8) == 4
    devs = port_runtime.shardings_for(mesh, specs)
    assert all(d == torch.device("cpu") for d in port_train.optimizer.tree_leaves(
        devs[0]))
    monkeypatch.setenv(FORCE_ENV, "8")
    big = compat_make_mesh((2, 4), ("data", "model"), "cpu")
    for x, y in zip(a, port_train.optimizer.tree_leaves(port_runtime.remesh(state, specs, big))):
        assert torch.equal(x, y)


def test_remesh_refusals(monkeypatch):
    """The reference's two messages: a zero-extent axis, and more devices
    than are available (a mesh object built past the count, as a stale
    device list would give)."""
    from repro_torch.launch.mesh import Mesh
    state = {"w": torch.ones(3)}
    specs = {"w": (None,)}
    zero = Mesh(("data", "model"), (0, 1), ())
    with pytest.raises(ValueError, match="extent 0"):
        port_runtime.remesh(state, specs, zero)
    monkeypatch.setenv(FORCE_ENV, "4")
    four = compat_make_mesh((2, 2), ("data", "model"), "cpu")
    monkeypatch.setenv(FORCE_ENV, "2")
    with pytest.raises(ValueError, match="needs 4 devices but only 2 are available"):
        port_runtime.remesh(state, specs, four)
    with pytest.raises(ValueError, match="not one of"):
        port_runtime.shardings_for(four, {"w": ("pod",)})


# --------------------------------------------------------------------------
# a reference checkpoint resumes in the port
# --------------------------------------------------------------------------

def test_reference_checkpoint_resumes_in_port(tmp_path):
    from repro.launch.mesh import compat_make_mesh as ref_mesh
    mesh = ref_mesh((1, 1), ("data", "model"))
    rc, pc, rp, pp = _both("llama3.2-1b", "float32")
    spec_kw = dict(lr=1e-3, warmup_steps=2, total_steps=30)
    r_opt, p_opt = ref_train.adamw(lr=1e-3), port_train.adamw(lr=1e-3)
    r_step = jax.jit(ref_train.make_train_step(rc, REF_PLAN, mesh, r_opt,
                                               ref_train.TrainSpec(**spec_kw)))
    p_step = port_train.make_train_step(pc, SINGLE_POD_PLAN, None, p_opt,
                                        port_train.TrainSpec(**spec_kw))
    data = ref_data.SyntheticLM(ref_data.DataConfig(vocab=pc.vocab, seq_len=32,
                                                    global_batch=2))

    def r_fn(state, i):
        p, o = state
        p, o, m = r_step(p, o, {k: jnp.asarray(v) for k, v in data.batch(i).items()},
                         jnp.asarray(i))
        return (p, o), m

    def p_fn(state, i):
        p, o = state
        p, o, m = p_step(p, o, data.batch(i), i)
        return (p, o), m

    ck = str(tmp_path / "ck")
    ref_runtime.Supervisor(ck, ckpt_every=2).run((rp, r_opt.init(rp)), r_fn, total_steps=4)
    # the reference goes on to step 5 in a copy of the directory
    import shutil
    shutil.copytree(ck, tmp_path / "ref5")
    r5 = ref_runtime.Supervisor(str(tmp_path / "ref5"), ckpt_every=2).run(
        (rp, r_opt.init(rp)), r_fn, total_steps=5)
    # the port resumes the reference's step-4 checkpoint and takes step 4
    template = (pp, p_opt.init(pp))
    p5 = port_runtime.Supervisor(ck, ckpt_every=2).run(template, p_fn, total_steps=5)
    assert [h["step"] for h in p5.metrics_history] == [4]
    (r_hist,) = [h for h in r5.metrics_history if h["step"] == 4]
    (p_hist,) = p5.metrics_history
    assert abs(p_hist["loss"] - r_hist["loss"]) <= 1e-5 * abs(r_hist["loss"])
    assert abs(p_hist["grad_norm"] - r_hist["grad_norm"]) <= 1e-4 * r_hist["grad_norm"]
    assert p_hist["lr"] == r_hist["lr"]
    # both step-5 checkpoints hold the same state, the port's as tensors
    got, manifest = port_restore(ck, 5, template=template)
    want, _ = port_restore(str(tmp_path / "ref5"), 5, template=template)
    assert manifest["step"] == 5
    assert int(got[1]["count"]) == 5 and got[1]["count"].dtype == torch.int32
    assert max(_leaf_dists(got[0], want[0]).values()) <= 2e-2


# --------------------------------------------------------------------------
# the pod gradient protocol
# --------------------------------------------------------------------------

_POD_REF = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.launch.mesh import compat_make_mesh
from repro.models.config import MULTI_POD_PLAN
from repro.configs import get_smoke
from repro.train import adamw, make_train_step, TrainSpec
import dataclasses
z = np.load(sys.argv[1])
tree = {}
for name in z.files:
    if name.startswith("batch/"):
        continue
    *path, leaf = name.split(".")
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = jnp.asarray(z[name])
batch = {k[6:]: jnp.asarray(z[k]) for k in z.files if k.startswith("batch/")}
mesh = compat_make_mesh((2, 1, 1), ("pod", "data", "model"))
cfg = dataclasses.replace(get_smoke("llama3.2-1b"), dtype="float32")
opt = adamw(lr=1e-3)
ts = jax.jit(make_train_step(cfg, MULTI_POD_PLAN, mesh, opt,
                             TrainSpec(lr=1e-3, warmup_steps=1, compress_pod_grads=True)))
p, _, m = ts(tree, opt.init(tree), batch, jnp.asarray(1))
out = {"loss": np.asarray(m["loss"]), "grad_norm": np.asarray(m["grad_norm"])}
for path, v in jax.tree_util.tree_flatten_with_path(p)[0]:
    out["p/" + ".".join(k.key for k in path)] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


def test_pod_protocol_matches_reference(tmp_path, monkeypatch):
    from repro_torch.train.optimizer import tree_leaves
    cfg = dataclasses.replace(get_smoke("llama3.2-1b"), dtype="float32")
    arrays = _f32_arrays(convert.seeded_model_arrays(cfg, 4))
    batch = port_data.SyntheticLM(port_data.DataConfig(vocab=cfg.vocab, seq_len=32,
                                                       global_batch=4, seed=4)).batch(0)
    np.savez(tmp_path / "in.npz", **arrays, **{f"batch/{k}": v for k, v in batch.items()})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _POD_REF, str(tmp_path / "in.npz"),
                          str(tmp_path / "out.npz")], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    want = dict(np.load(tmp_path / "out.npz"))

    monkeypatch.setenv(FORCE_ENV, "2")
    mesh = compat_make_mesh((2, 1, 1), ("pod", "data", "model"), "cpu")
    plan = plan_for_mesh(mesh)
    params = convert.model_params(arrays, "cpu")
    opt = port_train.adamw(lr=1e-3)
    spec = port_train.TrainSpec(lr=1e-3, warmup_steps=1, compress_pod_grads=True)
    step = port_train.make_train_step(cfg, plan, mesh, opt, spec)
    p, _, m = step(params, opt.init(params), batch, 1)
    assert abs(float(m["loss"]) - float(want["loss"])) <= 1e-5 * float(want["loss"])
    assert abs(float(m["grad_norm"]) - float(want["grad_norm"])) <= 1e-3 * float(want["grad_norm"])
    got = _flat(p)
    for k, v in got.items():
        w = want["p/" + k]
        assert float(np.abs(_np(v) - w).max()) <= 2e-2 * float(np.abs(w).max()), k

    # the bf16 payload is the pods' mean: the full batch's gradient
    from repro_torch.comm.protocols import wrap_grad_fn_with_pod_protocol
    from repro_torch.train.train_step import value_and_grad
    gf = value_and_grad(lambda pr, b: PT.loss_fn(pr, cfg, plan, mesh, b))
    tb = port_train.train_step.batch_to(batch, "cpu")
    (l_full, _), g_full = gf(params, tb)
    (l_pod, _), g_pod = wrap_grad_fn_with_pod_protocol(gf, mesh, payload="bf16")(params, tb)
    assert abs(float(l_pod) - float(l_full)) <= 1e-5 * float(l_full)
    for a, b in zip(tree_leaves(g_full), tree_leaves(g_pod)):
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max()) + 1e-12
    (l8, _), g8 = wrap_grad_fn_with_pod_protocol(gf, mesh, payload="int8")(params, tb)
    for a, b in zip(tree_leaves(g_full), tree_leaves(g8)):
        assert float((a - b).abs().max()) <= 2e-2 * float(a.abs().max()) + 1e-12
