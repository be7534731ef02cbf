"""The port's training path (``repro_torch.models.transformer.loss_fn``,
``repro_torch.train``, ``repro_torch.data``, ``repro_torch.launch.train``)
against the JAX package's.

Weights come from ``repro_torch.convert.seeded_model_arrays`` (NumPy,
seeded) and go to both packages; optimizer states cross through
``convert.opt_state``.  Contract, on the CPU with the kernels' plain
versions, at smoke size:

- ``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` of the
  reference's, for every architecture in ``all_arch_names()``: the loss
  within 1e-5 relative and each leaf within 1e-3 of its largest |g| in
  float32 activations, with the seeded bfloat16 weights widened to float32
  in both packages (a bfloat16 weight's gradient is itself rounded to
  bfloat16, one ulp of which is 4e-3 relative; leaves no gradient reaches
  are zero in both).  In bfloat16 activations and weights (the configs'
  own, the reference compiled as written) the loss within 1e-3 relative
  and each leaf within 5e-2 of its largest |g|, for llama3.2-1b,
  mamba2-780m, hymba-1.5b and qwen3-moe-235b-a22b: over seeds 0-2 and
  eight architectures the largest was 3.1e-2 (hymba-1.5b's dskip, seed 2)
  and the loss 8.8e-5 relative.  The MoE architectures' top-k routing is
  discontinuous (see tests/test_torch_model.py): they meet both bars at
  seed 0, the seed these tests use;
- ``remat="block"`` gives the same gradients as no remat, bitwise;
- three AdamW and three Adafactor train steps from the same params and
  state: every loss within 1e-5 relative, every parameter within 2e-2 of
  its largest |p| (bfloat16 params: a flipped sign of a near-zero gradient
  moves AdamW's first steps by 2 lr), the optimizer state's moments within
  1e-3 of their largest entry; ``lr_schedule`` and ``SyntheticLM`` bitwise;
  microbatches 1 against 2 within the reference's 5e-2;
- the int8 MoE payload's gradient (through the scales only) against the
  reference's;
- the launcher trains on the CPU, and without ``--smoke`` exits with the
  production mesh's device-count message;
- a kernel binding given a tensor that requires a gradient, with grad mode
  on, raises (the card's Functions are the differentiable ops).

The full-width fixtures ``tests/torch_golden/train_{llama,mamba}.{json,npz}``
(one AdamW step of the reference at full width, 2 layers, B = 1, S = 1,024,
``attn_impl="blockwise"``, float32 activations, weights from the NumPy seed
they record with the SSM's ``dt_bias`` at Mamba-2's initial dt of 0.01: the loss, the global and per-leaf gradient norms, and fixed
slices of the gradients and updated parameters) are written by

    PYTHONPATH=src python tests/test_torch_train.py --write-fixtures

and ``python3 chip_smoke.py`` holds the card's train step to them (path
(h)); ``test_train_fixture_recipe_on_narrow_twin`` holds the CPU's at smoke
width.
"""

import dataclasses
import json
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

from repro import configs as ref_configs  # noqa: E402
from repro import data as ref_data  # noqa: E402
from repro import train as ref_train  # noqa: E402
from repro.models import SINGLE_POD_PLAN as REF_PLAN  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as RT  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import data as port_data  # noqa: E402
from repro_torch import train as port_train  # noqa: E402
from repro_torch.configs import all_arch_names, get_config, get_smoke  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import SINGLE_POD_PLAN  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.train.train_step import value_and_grad  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests' tensors are small: one intra-op thread a test process
    (the suite runs several processes at once; restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
GOLDEN = REPO / "tests" / "torch_golden"
B, S = 2, 64
MOE = ("kimi-k2-1t-a32b", "qwen3-moe-235b-a22b")
#: the full-width fixtures: (file stem, arch)
FIXTURES = {"train_llama": "llama3.2-1b", "train_mamba": "mamba2-780m"}
FIXTURE_SEED, FIXTURE_LAYERS, FIXTURE_SEQ = 0, 2, 1024
#: the fixture's train step: AdamW at a constant lr, taken at step 1 (the
#: schedule's warmup of 1 step gives the full lr there)
FIXTURE_LR = 3e-4
#: the fixture's SSM time-step bias: softplus^-1(0.01), where Mamba-2's own
#: initializer puts dt (in [1e-3, 1e-1]).  The seeded init's 0 (dt ~ 0.8)
#: makes a 128-step chunk's decay pass e^-88, where the reference's
#: ssd_chunked takes exp of the unmasked upper triangle: its forward masks
#: the inf, its gradient is NaN (ROADMAP, queue 3)
FIXTURE_DT_BIAS = float(np.log(np.expm1(0.01)))
#: the fixture's slices: the leaves whose corner (``_slice``) is kept
FIXTURE_SLICES = {"llama3.2-1b": ("layers.attn.wq", "layers.mlp.wo", "unembed"),
                  "mamba2-780m": ("layers.ssm.wx", "layers.ssm.wdt", "unembed")}
#: the card's bars against the fixture (chip_smoke.py reads them from the
#: JSON): loss, global grad norm and per-leaf grad norms (summed in float64)
#: relative; grad slices within this share of their largest entry; updated
#: params more than the lr apart (a near-zero gradient's sign flips AdamW's
#: first step, 2 lr) at no more than this share of a slice's entries
FIXTURE_TOL = {"loss_rtol": 1e-4, "norm_rtol": 2e-3, "grad_slice_tol": 1e-2,
               "param_flip_share": 0.02}


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def ref_params(arrays):
    """Flat seeded arrays -> the reference's parameter tree (jnp)."""
    tree = {}
    for name, a in arrays.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16 else a)
    return tree


def _flat(tree, prefix=""):
    """A nested dict -> {"a.b.c": leaf}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = v
    return out


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _cfgs(name, dtype, smoke=True, **kw):
    rc = ref_configs.get_smoke(name) if smoke else ref_configs.get_config(name)
    pc = get_smoke(name) if smoke else get_config(name)
    return (dataclasses.replace(rc, dtype=dtype, **kw),
            dataclasses.replace(pc, dtype=dtype, **kw))


def _batch(cfg, rng, b=B, s=S):
    """(reference batch, port batch) with labels (a few masked)."""
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[:, :3] = -1
    ref = {"labels": jnp.asarray(labels)}
    port = {"labels": torch.from_numpy(labels)}
    if cfg.frontend == "tokens":
        tok = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        ref["tokens"], port["tokens"] = jnp.asarray(tok), torch.from_numpy(tok).long()
    else:
        e = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
        ref["embeddings"], port["embeddings"] = jnp.asarray(e), torch.from_numpy(e)
    return ref, port


def ref_as_written(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off (every bfloat16
    ``astype`` rounds as written, as in eager PyTorch)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def ref_loss_and_grads(rc, rp, rb, mesh, **kw):
    fn = jax.value_and_grad(lambda p, b: RT.loss_fn(p, rc, REF_PLAN, mesh, b, **kw),
                            has_aux=True)
    (loss, metrics), g = ref_as_written(fn, rp, rb)
    return float(loss), metrics, g


def port_loss_and_grads(pc, pp, pb, **kw):
    fn = value_and_grad(lambda p, b: PT.loss_fn(p, pc, SINGLE_POD_PLAN, None, b, **kw))
    (loss, metrics), g = fn(pp, pb)
    return float(loss), metrics, g


def _leaf_dists(pg, rg):
    """leaf name -> max |port - ref| / max |ref| (0 where both are zero)."""
    pf, rf = _flat(pg), _flat(rg)
    assert sorted(pf) == sorted(rf)
    out = {}
    for k in rf:
        p, r = _np(pf[k]), _np(rf[k])
        assert p.shape == r.shape, k
        scale = float(np.abs(r).max())
        diff = float(np.abs(p - r).max())
        out[k] = diff / scale if scale else diff
    return out


def _f32_arrays(arrays):
    """bfloat16 leaves (uint16 bit patterns) widened to float32 copies."""
    return {k: (v.astype(np.uint32) << 16).view(np.float32) if v.dtype == np.uint16 else v
            for k, v in arrays.items()}


def _both(name, dtype, seed=0, f32_params=False, **kw):
    """(ref cfg, port cfg, ref params, port params) from one NumPy seed;
    ``f32_params`` widens the bfloat16 weights to float32 in both (so that
    gradients are compared before a bfloat16 rounding of their own)."""
    rc, pc = _cfgs(name, dtype, **kw)
    arrays = convert.seeded_model_arrays(pc, seed)
    if f32_params:
        arrays = _f32_arrays(arrays)
    return rc, pc, ref_params(arrays), convert.model_params(arrays, "cpu")


# --------------------------------------------------------------------------
# loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", all_arch_names())
def test_loss_and_grads_match_reference_f32(name, mesh11):
    rc, pc, rp, pp = _both(name, "float32", f32_params=True)
    rb, pb = _batch(pc, np.random.default_rng(1))
    r_loss, r_m, rg = ref_loss_and_grads(rc, rp, rb, mesh11)
    p_loss, p_m, pg = port_loss_and_grads(pc, pp, pb)
    assert abs(p_loss - r_loss) <= 1e-5 * abs(r_loss)
    assert sorted(p_m) == sorted(r_m)
    assert float(p_m["tokens"]) == float(r_m["tokens"]) == B * (S - 3)
    dists = _leaf_dists(pg, rg)
    assert max(dists.values()) <= 1e-3, dists
    for k, v in _flat(pg).items():               # dtypes are the params'
        assert v.dtype == _flat(pp)[k].dtype, k
        assert bool(torch.isfinite(v.float()).all()), k


@pytest.mark.parametrize("name", ["llama3.2-1b", "mamba2-780m", "hymba-1.5b",
                                  "qwen3-moe-235b-a22b"])
def test_loss_and_grads_match_reference_bf16(name, mesh11):
    rc, pc, rp, pp = _both(name, "bfloat16")
    rb, pb = _batch(pc, np.random.default_rng(1))
    r_loss, _, rg = ref_loss_and_grads(rc, rp, rb, mesh11)
    p_loss, _, pg = port_loss_and_grads(pc, pp, pb)
    assert abs(p_loss - r_loss) <= 1e-3 * abs(r_loss)
    dists = _leaf_dists(pg, rg)
    assert max(dists.values()) <= 5e-2, dists


@pytest.mark.parametrize("name", ["llama3.2-1b", "mamba2-780m", "qwen3-moe-235b-a22b"])
def test_remat_block_gives_the_same_grads(name):
    _, pc, _, pp = _both(name, "float32")
    _, pb = _batch(pc, np.random.default_rng(2))
    _, _, g0 = port_loss_and_grads(pc, pp, pb)
    _, _, g1 = port_loss_and_grads(dataclasses.replace(pc, remat="block"), pp, pb)
    for k, v in _flat(g0).items():
        assert torch.equal(v, _flat(g1)[k]), k


def test_param_specs_match_reference():
    from jax.sharding import PartitionSpec
    for name in all_arch_names():
        rc, pc = _cfgs(name, "bfloat16")
        want = jax.tree.map(tuple, RT.param_specs(rc, REF_PLAN),
                            is_leaf=lambda x: isinstance(x, PartitionSpec))
        got = PT.param_specs(pc, SINGLE_POD_PLAN)
        assert _flat(got) == _flat(want), name
    # the optimizers' state specs follow
    specs = PT.param_specs(get_smoke("mamba2-780m"), SINGLE_POD_PLAN)
    st = port_train.adafactor().state_specs(specs)
    assert st["v"]["layers"]["ssm"]["wx"] == {"vr": (None, "data"), "vc": (None, "model")}
    assert st["v"]["layers"]["ssm"]["a_log"] == {"vr": (None,), "vc": ("model",)}
    assert port_train.adamw().state_specs(specs)["count"] == ()


def test_moe_int8_payload_grads_match_reference(mesh11):
    """The int8 dispatch payload's gradient flows through the scales only,
    in both packages (the CPU's autograd of quant_pack's plain version)."""
    cfg_r = dataclasses.replace(ref_configs.get_smoke("qwen3-moe-235b-a22b"), dtype="float32")
    cfg_p = dataclasses.replace(get_smoke("qwen3-moe-235b-a22b"), dtype="float32")
    arrays = {k.split(".")[-1]: v[0] for k, v in convert.seeded_model_arrays(cfg_p, 3).items()
              if k.startswith("layers.moe.")}
    x = np.random.default_rng(5).normal(0, 1, (2, 16, cfg_p.d_model)).astype(np.float32)
    r_opts = ref_moe.MoEOptions(payload="int8", capacity_factor=2.0)
    p_opts = port_moe.MoEOptions(payload="int8", capacity_factor=2.0)

    def r_loss(p, xx):
        y, aux = ref_moe.apply_moe(p, cfg_r, REF_PLAN, mesh11, xx, r_opts)
        return jnp.mean(y.astype(jnp.float32) ** 2) + 0.01 * aux["aux_loss"]
    rp = {k: jnp.asarray(v.view(jnp.bfloat16) if v.dtype == np.uint16 else v)
          for k, v in arrays.items()}
    rg, rgx = jax.jit(jax.grad(r_loss, argnums=(0, 1)))(rp, jnp.asarray(x))
    pp = {k: t.requires_grad_(True) for k, t in convert.moe_tensors(arrays, "cpu").items()}
    px = torch.from_numpy(x).requires_grad_(True)
    y, aux = port_moe.apply_moe(pp, cfg_p, SINGLE_POD_PLAN, None, px, p_opts)
    loss = torch.mean(y.float() ** 2) + 0.01 * aux["aux_loss"]
    loss.backward()
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(rgx), atol=1e-4 * float(np.abs(rgx).max()))
    for k in ("router", "w1", "wg", "w2"):
        want = _np(rg[k])
        got = _np(pp[k].grad)
        assert float(np.abs(got - want).max()) <= 1e-3 * float(np.abs(want).max()), k
    assert float(np.abs(_np(rg["w1"])).max()) > 0
    assert pp["hash_proj"].grad is None and float(np.abs(_np(rg["hash_proj"])).max()) == 0


@pytest.mark.parametrize("payload", ["bf16", "int8"])
def test_moe_grads_flow_through_the_fabric_on_a_mesh(payload, monkeypatch):
    """The reference's test_moe_grads_flow_through_fabric on the port, and
    over (data, model) meshes: the exchange between the shards' buffers is
    differentiable, and every layout's gradients are within the forward's
    3e-2 (tests/test_torch_mesh.py) of one device's."""
    from repro_torch.launch.mesh import FORCE_ENV, compat_make_mesh
    from repro_torch.models.config import ModelConfig, ShardingPlan
    monkeypatch.setenv(FORCE_ENV, "8")
    cfg = ModelConfig(name="t", family="moe", n_layers=1, d_model=128, n_heads=4,
                      n_kv_heads=2, d_ff=256, vocab=512, moe_experts=8, moe_topk=2,
                      capacity_factor=8.0)
    plan = ShardingPlan()
    params = port_moe.init_moe(torch.Generator().manual_seed(0), cfg, plan)
    x = torch.randn(8, 32, 128, generator=torch.Generator().manual_seed(1))

    def grads(mesh):
        pp = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        y, _ = port_moe.apply_moe(pp, cfg, plan, mesh, x, port_moe.MoEOptions(
            payload=payload, capacity_factor=8.0))
        torch.mean(y.float() ** 2).backward()
        return {k: pp[k].grad for k in ("router", "w1", "wg", "w2")}
    one = grads(None)
    assert float(one["w1"].float().norm()) > 0 and float(one["router"].norm()) > 0
    for shape in ((2, 4), (8, 1)):
        g = grads(compat_make_mesh(shape, ("data", "model"), "cpu"))
        for k, v in one.items():
            assert float((g[k].float() - v.float()).abs().max()) <= 3e-2 * float(
                v.float().abs().max()), (shape, k)


def test_quant_closed_form_grad_matches_plain_autograd():
    """quant_pack's CUDA-path Functions compute the scale-only gradient in
    closed form; on the CPU it must equal autograd of the plain version
    (exercised here with the Functions' backward on CPU tensors)."""
    from repro_torch.kernels.quant_pack import ops as qops
    from repro_torch.kernels.quant_pack.ref import dequantize_ref, quantize_ref
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (6, 256)).astype(np.float32)
    x[0, :128] = 0.0                          # an all-zero group: no gradient
    x[1, 5] = x[1, 9] = 4.0                   # a tie at the group's max
    x[2, 7] = -5.0                            # a negative max
    gy = torch.from_numpy(rng.normal(0, 1, (6, 256)).astype(np.float32))
    xt = torch.from_numpy(x).requires_grad_(True)
    q, s = quantize_ref(xt)
    (dequantize_ref(q, s) * gy).sum().backward()

    class Ctx:
        saved_tensors = ()
    ctx = Ctx()
    ctx.saved_tensors = (q,)
    _, ds, _ = qops.DequantizeFn.backward(ctx, gy)
    ctx.saved_tensors = (torch.from_numpy(x),)
    dx = qops.QuantizeFn.backward(ctx, None, ds)
    assert torch.equal(dx, xt.grad)
    assert float(dx[0, :128].abs().max()) == 0.0
    assert float(dx[1, 5]) == float(dx[1, 9]) != 0.0


# --------------------------------------------------------------------------
# the launcher, the kernel bindings' guard
# --------------------------------------------------------------------------

def test_train_launcher_runs_on_cpu(tmp_path, capsys):
    rc = launcher.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "4",
                        "--device", "cpu", "--batch", "2", "--seq", "32",
                        "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "4 steps in" in out
    assert (tmp_path / "step_00000004" / "manifest.json").exists()
    assert launcher.main(["--arch", "llama3.2-1b", "--steps", "4", "--device", "cpu"]) == 2
    assert "needs 256 devices but only 1 are available" in capsys.readouterr().err


def test_kernel_bindings_refuse_grad_inputs():
    """A binding's output carries no autograd history: given an input that
    requires a gradient under grad mode it raises, before it looks at the
    device; under no_grad it goes on to its own checks."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.quant_pack import kernel as qk
    from repro_torch.kernels.ssd import kernel as sk
    q = torch.zeros((1, 2, 8, 32), requires_grad=True)
    x, dt, a = (torch.zeros((2, 8, 32), requires_grad=True), torch.zeros((2, 8)),
                torch.zeros((2,)))
    bc = torch.zeros((1, 8, 16))
    calls = [lambda: fk.flash_attention(q, q, q),
             lambda: fk.flash_attention_bwd(q, q, q, q, q),
             lambda: sk.ssd_scan(x, dt, a, bc, bc),
             lambda: sk.ssd_scan_bwd(x, dt, a, bc, bc, x),
             lambda: qk.quantize(torch.zeros((2, 128), requires_grad=True)),
             lambda: qk.dequantize(torch.zeros((2, 128), dtype=torch.int8),
                                   torch.zeros((2, 1), requires_grad=True))]
    for call in calls:
        with pytest.raises(RuntimeError, match="requires a gradient"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.cuda
def test_cuda_kernel_bindings_refuse_grad_inputs_and_ops_differentiate():
    """On the card: each binding refuses a grad-requiring input under grad
    mode; the ops (the autograd Functions) give every input a gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import ssd
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.quant_pack import kernel as qk
    from repro_torch.kernels.ssd import kernel as sk
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    q = torch.randn((1, 4, 128, 64), device=dev, generator=g, requires_grad=True)
    k, v = (torch.randn((1, 2, 128, 64), device=dev, generator=g, requires_grad=True)
            for _ in range(2))
    x = torch.randn((4, 128, 64), device=dev, generator=g, requires_grad=True)
    dt = torch.rand((4, 128), device=dev, generator=g).requires_grad_(True)
    a = -torch.ones(4, device=dev, requires_grad=True)
    b, c = (torch.randn((1, 128, 16), device=dev, generator=g, requires_grad=True)
            for _ in range(2))
    w = torch.randn((8, 128), device=dev, generator=g, requires_grad=True)
    for call in (lambda: fk.flash_attention(q, k, v), lambda: sk.ssd_scan(x, dt, a, b, c),
                 lambda: qk.quantize(w)):
        with pytest.raises(RuntimeError, match="requires a gradient"):
            call()
    o = fa.flash_attention(q, k, v)
    y = ssd.ssd_chunked(x, dt, a, b, c)
    qq, ss = qp.quantize(w)
    z = qp.dequantize(qq, ss)
    loss = o.float().square().sum() + y.float().square().sum() + z.square().sum()
    leaves = (q, k, v, x, dt, a, b, c, w)
    grads = torch.autograd.grad(loss, leaves)
    assert all(gr is not None and bool(torch.isfinite(gr).all()) and bool((gr != 0).any())
               for gr in grads)


def test_training_path_imports_no_jax():
    import subprocess
    code = ("import sys; import repro_torch.train, repro_torch.data, repro_torch.runtime, "
            "repro_torch.comm.protocols, repro_torch.launch.train; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr


# --------------------------------------------------------------------------
# the full-width fixtures
# --------------------------------------------------------------------------

def fixture_config(arch, smoke=False):
    """(reference cfg, port cfg) of a fixture: full width, depth cut to
    FIXTURE_LAYERS, float32 activations, attention forced through the
    blockwise path, remat as the config has it."""
    return _cfgs(arch, "float32", smoke=smoke, n_layers=FIXTURE_LAYERS,
                 attn_impl="blockwise")


def fixture_batch(cfg, seed=FIXTURE_SEED, seq=FIXTURE_SEQ):
    """The fixture's batch: SyntheticLM at (seed, step 0), one sequence
    (the fixture stores it: ``Generator.zipf``, under SyntheticLM's
    unigram table, draws other numbers in other NumPy versions)."""
    return port_data.SyntheticLM(port_data.DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=1, seed=seed)).batch(0)


def fixture_arrays(cfg):
    """The fixture's weights: the NumPy seed's, with the SSM's ``dt_bias``
    at FIXTURE_DT_BIAS."""
    arrays = convert.seeded_model_arrays(cfg, FIXTURE_SEED)
    if "layers.ssm.dt_bias" in arrays:
        arrays["layers.ssm.dt_bias"] = np.full_like(arrays["layers.ssm.dt_bias"],
                                                    FIXTURE_DT_BIAS)
    return arrays


def fixture_spec():
    return dict(lr=FIXTURE_LR, warmup_steps=1, total_steps=100, schedule="const")


def _slice(a):
    """A fixed corner of a leaf: the first 32 x 32 of its last two dims (of
    layer 0 for stacked leaves)."""
    a = a[0] if a.ndim == 3 else a
    return a[..., :32, :32] if a.ndim >= 2 else a[:32]


def ref_fixture_step(arch, smoke=False, seq=FIXTURE_SEQ):
    """The reference's fixture step: (loss, grad norm, per-leaf grad norms,
    grad slices, param slices before and after, the batch) as NumPy."""
    from repro.launch.mesh import compat_make_mesh
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    rc, pc = fixture_config(arch, smoke)
    rp = ref_params(fixture_arrays(pc))
    np_batch = fixture_batch(pc, seq=seq)
    batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(p, rc, REF_PLAN, mesh, b), has_aux=True))(rp, batch)
    opt = ref_train.adamw(lr=FIXTURE_LR)
    step = jax.jit(ref_train.make_train_step(rc, REF_PLAN, mesh, opt,
                                             ref_train.TrainSpec(**fixture_spec())))
    new_p, _, m = step(rp, opt.init(rp), batch, jnp.asarray(1))
    gf, pf, nf = _flat(g), _flat(rp), _flat(new_p)
    names = FIXTURE_SLICES[arch]
    return {"loss": float(loss), "grad_norm": float(m["grad_norm"]),
            "leaf_norms": {k: float(np.linalg.norm(np.asarray(v.astype(jnp.float32),
                                                              np.float64).reshape(-1)))
                           for k, v in sorted(gf.items())},
            "grads": {k: np.asarray(_slice(gf[k]).astype(jnp.float32)) for k in names},
            "params": {k: np.asarray(_slice(pf[k]).astype(jnp.float32)) for k in names},
            "updated": {k: np.asarray(_slice(nf[k]).astype(jnp.float32)) for k in names},
            "batch": np_batch}


def port_fixture_step(arch, device, smoke=False, seq=FIXTURE_SEQ):
    """The port's fixture step, the same quantities (``chip_smoke.py``
    runs it on the card)."""
    _, pc = fixture_config(arch, smoke)
    pp = convert.model_params(fixture_arrays(pc), device)
    batch = port_train.train_step.batch_to(fixture_batch(pc, seq=seq), device)
    (loss, _), g = value_and_grad(
        lambda p, b: PT.loss_fn(p, pc, SINGLE_POD_PLAN, None, b))(pp, batch)
    opt = port_train.adamw(lr=FIXTURE_LR)
    step = port_train.make_train_step(pc, SINGLE_POD_PLAN, None, opt,
                                      port_train.TrainSpec(**fixture_spec()))
    new_p, _, m = step(pp, opt.init(pp), batch, 1)
    gf, pf, nf = _flat(g), _flat(pp), _flat(new_p)
    names = FIXTURE_SLICES[arch]
    return {"loss": float(loss), "grad_norm": float(m["grad_norm"]),
            "leaf_norms": {k: float(torch.linalg.vector_norm(v.double())) for k, v in gf.items()},
            "grads": {k: _slice(gf[k]).float().cpu().numpy() for k in names},
            "params": {k: _slice(pf[k]).float().cpu().numpy() for k in names},
            "updated": {k: _slice(nf[k]).float().cpu().numpy() for k in names}}


def compare_fixture_step(got, want, tol):
    """The checks of a fixture step against the reference's: a dict of
    named measures and ``ok``."""
    out = {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
           "grad_norm_rel": abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]}
    out["leaf_norm_rel"] = max(abs(got["leaf_norms"][k] - v) / v if v else
                               abs(got["leaf_norms"][k]) for k, v in want["leaf_norms"].items())
    out["grad_slice_share"] = max(
        float(np.abs(got["grads"][k] - w).max() / (tol["grad_slice_tol"] * np.abs(w).max()))
        for k, w in want["grads"].items())
    out["param_flip_share"] = max(float(np.mean(np.abs(got["updated"][k] - w) > FIXTURE_LR))
                                  for k, w in want["updated"].items())
    out["params_moved_share"] = min(float(np.mean(want["updated"][k] != want["params"][k]))
                                    for k in want["updated"])
    out["ok"] = (out["loss_rel"] <= tol["loss_rtol"] and out["grad_norm_rel"] <= tol["norm_rtol"]
                 and out["leaf_norm_rel"] <= tol["norm_rtol"] and out["grad_slice_share"] <= 1.0
                 and out["param_flip_share"] <= tol["param_flip_share"]
                 and sorted(got["leaf_norms"]) == sorted(want["leaf_norms"]))
    return out


def write_fixtures(names=None):
    import time
    GOLDEN.mkdir(parents=True, exist_ok=True)
    for stem, arch in FIXTURES.items():
        if names and stem not in names and arch not in names:
            continue
        t0 = time.time()
        r = ref_fixture_step(arch)
        arrays = {}
        for part in ("grads", "params", "updated", "batch"):
            for k, v in r[part].items():
                arrays[f"{part}/{k}"] = v
        np.savez_compressed(GOLDEN / f"{stem}.npz", **arrays)
        meta = {"arch": arch, "n_layers": FIXTURE_LAYERS, "seed": FIXTURE_SEED,
                "batch": 1, "seq": FIXTURE_SEQ, "attn_impl": "blockwise",
                "dtype": "float32", "lr": FIXTURE_LR, "optimizer": "adamw",
                "spec": fixture_spec(), "step": 1,
                "weights": "repro_torch.convert.seeded_model_arrays(cfg, seed), "
                           "layers.ssm.dt_bias set to dt_bias",
                "dt_bias": FIXTURE_DT_BIAS,
                "data": "SyntheticLM(DataConfig(vocab, seq, 1, seed)).batch(0), stored "
                        "(batch/*): its Generator.zipf draws differ between NumPy "
                        "versions",
                "loss": r["loss"], "grad_norm": r["grad_norm"],
                "leaf_norms": r["leaf_norms"], "slices": list(FIXTURE_SLICES[arch]),
                "tolerance": FIXTURE_TOL, "jax": jax.__version__,
                "written_by": "PYTHONPATH=src python tests/test_torch_train.py "
                              "--write-fixtures"}
        (GOLDEN / f"{stem}.json").write_text(json.dumps(meta, indent=1) + "\n")
        print(f"{stem}: {time.time() - t0:.1f}s, loss {r['loss']:.4f}, "
              f"grad norm {r['grad_norm']:.4f}")


def load_fixture(stem):
    meta = json.loads((GOLDEN / f"{stem}.json").read_text())
    want = {"loss": meta["loss"], "grad_norm": meta["grad_norm"],
            "leaf_norms": meta["leaf_norms"], "grads": {}, "params": {}, "updated": {},
            "batch": {}}
    with np.load(GOLDEN / f"{stem}.npz") as z:
        for key in z.files:
            part, name = key.split("/", 1)
            want[part][name] = z[key]
    return meta, want


@pytest.mark.parametrize("stem", sorted(FIXTURES))
def test_train_fixture_records_its_inputs(stem):
    meta, want = load_fixture(stem)
    _, pc = fixture_config(FIXTURES[stem])
    assert meta["arch"] == FIXTURES[stem] and meta["n_layers"] == FIXTURE_LAYERS
    assert meta["seed"] == FIXTURE_SEED and meta["seq"] == FIXTURE_SEQ
    assert meta["tolerance"] == FIXTURE_TOL and meta["spec"] == fixture_spec()
    assert meta["dt_bias"] == FIXTURE_DT_BIAS
    assert sorted(want["grads"]) == sorted(FIXTURE_SLICES[FIXTURES[stem]])
    tok, lab = want["batch"]["tokens"], want["batch"]["labels"]
    assert tok.shape == lab.shape == (1, FIXTURE_SEQ) and tok.dtype == lab.dtype == np.int32
    np.testing.assert_array_equal(lab[:, :-1], tok[:, 1:])     # next-token labels
    assert sorted(meta["leaf_norms"]) == sorted(_flat(PT.param_specs(pc, SINGLE_POD_PLAN)))
    assert np.isfinite(meta["loss"]) and 0 < meta["grad_norm"]
    size = sum((GOLDEN / f"{stem}.{ext}").stat().st_size for ext in ("json", "npz"))
    assert size < 2 * 2 ** 20


@pytest.mark.parametrize("stem", sorted(FIXTURES))
def test_train_fixture_recipe_on_narrow_twin(stem):
    """The fixture's recipe (config cut, blockwise attention, float32
    activations, seeded weights, SyntheticLM, one AdamW step) at smoke width
    and 128 tokens: the port's step against the reference's under the
    fixture's bars."""
    arch = FIXTURES[stem]
    want = ref_fixture_step(arch, smoke=True, seq=128)
    got = port_fixture_step(arch, "cpu", smoke=True, seq=128)
    res = compare_fixture_step(got, want, FIXTURE_TOL)
    assert res["ok"], res
    assert res["params_moved_share"] >= 0.5, res


if __name__ == "__main__":
    if sys.argv[1:2] == ["--write-fixtures"]:
        write_fixtures(sys.argv[2:] or None)
    else:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_train.py "
                 "--write-fixtures [train_llama|train_mamba ...]")
