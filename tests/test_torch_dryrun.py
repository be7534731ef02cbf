"""The port's dry-run (``repro_torch.launch.{roofline,specs,dryrun}``)
against the JAX package's.

The reference runs once, in two subprocesses with 512 forced host devices
(its production meshes need them), started by the first test and read by
the tests that need it: its records of llama3.2-1b's train_4k, prefill_32k
and decode_32k cells (``lower_cell``), every (arch, shape, mesh) cell's
``input_specs`` (shapes, dtypes, sanitized ``PartitionSpec``s),
``choose_optimizer`` and ``choose_microbatches``, and the HLO text of one
compiled cell with its ``collective_bytes``.  Contract, on the CPU:

- the framework-free pieces exactly: ``structural_memory_bytes``,
  ``model_flops`` and ``derive_terms(...).as_dict()`` under ``TPU_V5E`` for
  every (arch, shape, mesh), the optimizer's name and the microbatches, and
  ``collective_bytes`` on the reference's HLO;
- ``input_specs``: every leaf's shape, dtype and sanitized spec equal to the
  reference's, for every (arch, shape, mesh);
- the meta count equals a real run: at smoke width the same step on CPU
  tensors gives the same ``FlopCounterMode`` total, bytes and peak live
  bytes as on meta; a one-matmul step's count by hand, a view not counted
  twice;
- the MoE layer's static-shape expert count is bitwise ``bincount``'s;
- ``main`` on llama3.2-1b decode_32k ``--mesh single`` exits 0 with no
  card, its record has the reference record's keys (and
  ``collectives_from``), and the forced device count is unset afterwards;
- llama3.2-1b train_4k and prefill_32k: ``cost.flops`` within 10 % of the
  reference's, ``argument_bytes`` within 1 %; train_4k's dominant term
  equal.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.experimental

# jax 0.9 dropped jax.experimental.enable_x64, which the reference's batched
# engines import; alias it to the scoped config switch before importing them
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import pytest  # noqa: E402
import torch  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402

from repro_torch.configs import SHAPES, all_arch_names, get_config, get_smoke, shapes_for  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.kernels.build import takes_plain  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import (FORCE_ENV, forced_device_count,  # noqa: E402
                                     make_production_mesh, plan_for_mesh)
from repro_torch.launch.specs import abstract_params, input_specs, sharding_tree  # noqa: E402
from repro_torch.models import SINGLE_POD_PLAN  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.moe import MoEOptions, expert_counts  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}

#: the reference's side, run in one process with 512 forced host devices
REF_SCRIPT = r'''
import dataclasses, functools, json, sys
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
from jax.sharding import PartitionSpec as P
import repro.launch.specs as RS
from repro.configs import SHAPES, all_arch_names, get_config, shapes_for
from repro.launch.dryrun import _lower_one, choose_microbatches, choose_optimizer, lower_cell
from repro.launch.mesh import make_production_mesh, plan_for_mesh
from repro.launch.roofline import collective_bytes
from repro.models.moe import MoEOptions
# one abstract parameter tree per (config, plan), not one per cell
RS.abstract_params = functools.lru_cache(maxsize=None)(RS.abstract_params)

def entry(ax):
    return None if ax is None else ax if isinstance(ax, str) else list(ax)

def flat(structs, specs, mesh):
    rows = jax.tree.map(
        lambda st, s: [list(st.shape), str(st.dtype),
                       [entry(a) for a in RS._sanitize_spec(st.shape, s, mesh)]],
        structs, specs, is_leaf=lambda x: isinstance(x, (P, jax.ShapeDtypeStruct)))
    leaves = jax.tree_util.tree_flatten_with_path(
        rows, is_leaf=lambda x: isinstance(x, list) and len(x) == 3 and isinstance(x[1], str))[0]
    return {"/".join(str(k.key) for k in path): v for path, v in leaves}

res = {"specs": {}, "optimizer": {}, "microbatches": {}, "records": {}}
meshes = {m: make_production_mesh(multi_pod=m == "multi") for m in ("single", "multi")}
part = sys.argv[3]
for arch in all_arch_names() if part == "specs" else ():
    cfg = get_config(arch)
    opt, res["optimizer"][arch] = choose_optimizer(cfg)
    for shape in shapes_for(cfg):
        for m, mesh in meshes.items():
            key = f"{arch}|{shape.name}|{m}"
            spec = RS.input_specs(cfg, shape, plan_for_mesh(mesh), mesh, opt=opt)
            res["specs"][key] = {
                part: flat(spec[part], spec["opt_spec" if part == "opt_state" else part + "_spec"], mesh)
                for part in ("params", "opt_state", "batch", "tok", "state") if part in spec}
            res["microbatches"][key] = choose_microbatches(cfg, shape, mesh)
for shape in ("train_4k", "prefill_32k", "decode_32k") if part == "records" else ():
    res["records"][shape] = lower_cell("llama3.2-1b", shape, verbose=False)
if part == "specs":
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=1, scan_layers=False,
                              attn_unroll=True)
    mesh = meshes["single"]
    text = _lower_one(cfg, SHAPES["decode_32k"], plan_for_mesh(mesh), mesh,
                      choose_optimizer(cfg)[0], MoEOptions.from_config(cfg), 1).compile().as_text()
    with open(sys.argv[2], "w") as f:
        f.write(text)
    res["hlo_collectives"] = collective_bytes(text)
with open(sys.argv[1], "w") as f:
    json.dump(res, f)
'''


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Meta counts are dispatch-bound: one intra-op thread a test process
    (the suite runs several processes at once; restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Reference:
    """The reference's side in two subprocesses (the three records; the
    specs, choices and HLO), started at once, read when first needed."""

    PARTS = ("records", "specs")

    def __init__(self, tmp: Path):
        self.hlo = tmp / "ref.hlo"
        env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
                   JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
        env.pop(FORCE_ENV, None)
        self.outs = {part: tmp / f"ref_{part}.json" for part in self.PARTS}
        self.procs = {part: subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, str(out), str(self.hlo), part],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for part, out in self.outs.items()}
        self._res = None

    def result(self):
        if self._res is None:
            res = {}
            for part, proc in self.procs.items():
                _, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, err[-4000:]
                for k, v in json.loads(self.outs[part].read_text()).items():
                    res[k] = {**res.get(k, {}), **v} if isinstance(v, dict) else v
            self._res = res
        return self._res

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(autouse=True, scope="module")
def ref(tmp_path_factory):
    r = _Reference(tmp_path_factory.mktemp("dryrun_ref"))
    yield r
    r.close()


def _production_mesh(name):
    with forced_device_count(512):
        return make_production_mesh(multi_pod=name == "multi", device="cpu")


# ------------------------------------------------------------ framework-free

@pytest.mark.parametrize("arch", all_arch_names())
def test_framework_free_pieces_equal(arch):
    """structural_memory_bytes, model_flops and derive_terms(...).as_dict()
    under TPU_V5E, bitwise the reference's for every shape and mesh."""
    cfg, rcfg = get_config(arch), ref_configs.get_config(arch)
    assert roofline.TPU_V5E == ref_roofline.TPU_V5E
    for shape in shapes_for(cfg):
        rshape = ref_configs.SHAPES[shape.name]
        mf = roofline.model_flops(cfg, shape)
        assert mf == ref_roofline.model_flops(rcfg, rshape)
        for mesh_shape in MESHES.values():
            n = 1
            for v in mesh_shape.values():
                n *= v
            for opt in ("adamw", "adafactor"):
                mem = roofline.structural_memory_bytes(cfg, shape, mesh_shape, opt)
                assert mem == ref_roofline.structural_memory_bytes(rcfg, rshape, mesh_shape, opt)
            cost = {"flops": mf / n * 1.37, "bytes accessed": mf / n / 3.0}
            coll = {"all-gather": {"count": 7, "bytes": mf / n / 1e3},
                    "all-reduce": {"count": 3, "bytes": mem / 11.0}}
            for kw in ({"memory_bytes": mem}, {}):
                got = roofline.derive_terms(cost, coll, model_flops_global=mf, n_chips=n, **kw)
                want = ref_roofline.derive_terms(cost, coll, model_flops_global=mf,
                                                 n_chips=n, **kw)
                assert got.as_dict() == want.as_dict()


def test_h100_terms_price_with_their_own_peak():
    """The port's terms carry the peak they were derived with (the
    reference's roofline_fraction divides by TPU_V5E's whatever hw)."""
    cfg = get_config("llama3.2-1b")
    shape = ShapeSpec("card", 8192, 1, "train")
    mf = roofline.model_flops(cfg, shape)
    t = roofline.derive_terms({"flops": 2 * mf}, {}, model_flops_global=mf, n_chips=1,
                              memory_bytes=1e9, hw=roofline.H100_SXM)
    assert t.dominant == "compute"
    assert t.compute_s == 2 * mf / 989.4e12
    assert t.roofline_fraction == mf / (989.4e12 * t.bound_s) == pytest.approx(0.5)
    assert "peak_flops" not in t.as_dict()


# ---------------------------------------------------------------- the specs

def _entry(ax):
    return None if ax is None else ax if isinstance(ax, str) else list(ax)


def _flat(structs, specs, mesh):
    """leaf path -> [shape, dtype, sanitized spec], in the reference's form."""
    sanitized = sharding_tree(mesh, specs, structs)
    out = {}

    def walk(st, sp, path):
        if isinstance(st, dict):
            for k in sorted(st):
                walk(st[k], sp[k], path + [str(k)])
        else:
            out["/".join(path)] = [list(st.shape), str(st.dtype).replace("torch.", ""),
                                   [_entry(a) for a in sp]]
    walk(structs, sanitized, [])
    return out


@pytest.mark.parametrize("arch", all_arch_names())
def test_abstract_params_are_init_params_without_a_draw(arch):
    cfg = get_smoke(arch)
    gen = torch.Generator().manual_seed(0)
    real = PT.init_params(gen, cfg, SINGLE_POD_PLAN)
    meta, specs = abstract_params(cfg, SINGLE_POD_PLAN)
    r, m = dryrun._tensors(real), dryrun._tensors(meta)
    assert [(t.shape, t.dtype) for t in r] == [(t.shape, t.dtype) for t in m]
    assert all(t.device.type == "meta" for t in m)
    assert specs == PT.param_specs(cfg, SINGLE_POD_PLAN)


# ----------------------------------------------------------------- counting

def test_one_matmul_count_by_hand():
    """x [4, 8] @ w [8, 16] in float32, a transposed view of the product,
    then the view times 2: 2·4·8·16 FLOP; bytes 128 + 512 + 256 (mm) + 0
    (the view) + 256 + 256 (mul); live at peak the product and the result,
    256 + 256, the view sharing the product's storage."""
    def step(x, w):
        y = torch.mm(x, w)
        return y.t() * 2.0

    for dev in ("cpu", "meta"):
        x, w = torch.ones(4, 8, device=dev), torch.ones(8, 16, device=dev)
        c = dryrun.count_step(step, x, w)
        assert (c.flops, c.bytes_accessed, dryrun.peak_live_bytes(step, x, w)) == (
            1024, 1408, 512), dev


@pytest.mark.parametrize("arch,kind", [("llama3.2-1b", "train"), ("mamba2-780m", "train"),
                                       ("qwen3-moe-235b-a22b", "train"),
                                       ("hymba-1.5b", "prefill"), ("qwen2-vl-72b", "train"),
                                       ("llama3.2-1b", "decode")])
def test_meta_count_equals_a_real_run(arch, kind):
    """The same step at smoke width on CPU tensors and on meta tensors:
    the same FLOP total, bytes and peak live bytes."""
    cfg = dataclasses.replace(get_smoke(arch), attn_unroll=True, remat="block")
    shape = ShapeSpec("t", 64, 2, "decode" if kind == "decode" else kind)
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 1}, axis_names=("data", "model"))
    spec = input_specs(cfg, shape, SINGLE_POD_PLAN, mesh)
    gen = torch.Generator().manual_seed(0)

    def real(t):
        if t.dtype in (torch.int32, torch.int64):
            return torch.randint(0, cfg.vocab, t.shape, generator=gen, dtype=t.dtype)
        return torch.randn(t.shape, generator=gen).to(t.dtype)

    fn, names = dryrun._step(cfg, shape, SINGLE_POD_PLAN, MoEOptions.from_config(cfg))
    counts = []
    for to in (real, lambda t: t):
        args = [dryrun.tree_map(to, spec[n]) for n in names]
        if kind == "train":
            args[0] = dryrun.tree_map(lambda p: p.detach().requires_grad_(True), args[0])
        counts.append(dryrun.count_step(fn, *args))
        if kind == "train":     # a fresh graph for the second run
            args[0] = dryrun.tree_map(lambda p: p.detach().requires_grad_(True), args[0])
        counts.append(dryrun.peak_live_bytes(fn, *args))
    (want, want_live), (got, got_live) = counts[:2], counts[2:]
    assert got.flops == want.flops > 0
    # a size-1 dimension's stride may differ between an operation's meta
    # and CPU kernels, so a later reshape copies on one and not the other
    # (mamba2-780m's smoke step: one 8 KiB clone on the CPU, 16 KiB of 125 MB)
    assert got.bytes_accessed == pytest.approx(want.bytes_accessed, rel=1e-3)
    assert got_live == pytest.approx(want_live, rel=1e-3)


@pytest.mark.parametrize("arch,kind", [("llama3.2-1b", "train"), ("mamba2-780m", "prefill"),
                                       ("qwen3-moe-235b-a22b", "train")])
def test_flops_scale_with_rows(arch, kind):
    """A count of 1 row times 4 is the 4-row count's FLOP exactly, but not
    its bytes: each run reads the weights once (so one device's rows
    times dp cannot stand in for the global count's bytes)."""
    cfg = dataclasses.replace(get_smoke(arch), attn_unroll=True)
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 1}, axis_names=("data", "model"))
    moe = MoEOptions.from_config(cfg)
    one, four = (dryrun._run(dryrun.count_step, cfg, ShapeSpec("t", 64, b, kind),
                             SINGLE_POD_PLAN, mesh, moe) for b in (1, 4))
    assert 4 * one.flops == four.flops > 0
    assert 4 * one.bytes_accessed > four.bytes_accessed


def test_kernel_wrappers_take_the_plain_version_on_meta():
    """A meta tensor goes through the plain versions (shapes only), a CPU
    one too; any device but CUDA, CPU and meta raises."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_pack import dequantize, quantize
    from repro_torch.kernels.ssd.ops import ssd_chunked
    m = torch.device("meta")
    q = torch.empty(1, 4, 256, 32, device=m, dtype=torch.bfloat16)
    kv = torch.empty(1, 2, 256, 32, device=m, dtype=torch.bfloat16)
    assert flash_attention(q, kv, kv).shape == q.shape
    y = ssd_chunked(torch.empty(4, 256, 16, device=m), torch.empty(4, 256, device=m),
                    torch.empty(4, device=m), torch.empty(1, 256, 8, device=m),
                    torch.empty(1, 256, 8, device=m))
    assert y.shape == (4, 256, 16) and y.device == m
    codes, scales = quantize(torch.empty(8, 256, device=m))
    assert codes.shape == (8, 256) and codes.dtype == torch.int8 and scales.shape == (8, 2)
    assert dequantize(codes, scales).shape == (8, 256)
    assert takes_plain(torch.empty(1)) and takes_plain(q)
    with pytest.raises(ValueError, match="xpu"):
        takes_plain(types.SimpleNamespace(device=torch.device("xpu")))


@pytest.mark.parametrize("seed", range(4))
def test_static_expert_count_is_bincount(seed):
    gen = torch.Generator().manual_seed(seed)
    for e, n in ((8, 1), (8, 64), (128, 8192), (384, 3)):
        ids = torch.randint(0, e, (n,), generator=gen)
        want = torch.bincount(ids, minlength=e)
        got = expert_counts(ids, e)
        assert got.dtype == want.dtype == torch.int64
        assert torch.equal(got, want)
        assert torch.equal(expert_counts(ids.to(torch.int32).reshape(-1, 1), e), want)
    assert expert_counts(torch.empty(16, dtype=torch.int64, device="meta"), 8).shape == (8,)


# ------------------------------ against the reference's run (it runs meanwhile)

def test_llama_cells_against_reference(ref):
    """llama3.2-1b train_4k and prefill_32k: flops within 10 %,
    argument_bytes within 1 %, train_4k's dominant term equal."""
    before = os.environ.get(FORCE_ENV)
    got = {s: dryrun.lower_cell("llama3.2-1b", s, verbose=False)
           for s in ("train_4k", "prefill_32k")}
    assert os.environ.get(FORCE_ENV) == before
    want = ref.result()["records"]
    for s, rec in got.items():
        w = want[s]
        assert rec["cost"]["flops"] == pytest.approx(w["cost"]["flops"], rel=0.10), s
        assert rec["memory"]["argument_bytes"] == pytest.approx(
            w["memory"]["argument_bytes"], rel=0.01), s
        _live_within_2x(rec, w)
        for term in ("compute_s", "memory_s", "collective_s"):
            assert 0 < rec["roofline"][term] < float("inf"), (s, term)
    assert got["train_4k"]["roofline"]["dominant"] == want["train_4k"]["roofline"]["dominant"]
    assert got["train_4k"]["optimizer"] == want["train_4k"]["optimizer"]
    assert got["train_4k"]["microbatches"] == want["train_4k"]["microbatches"]


def _live_within_2x(rec, want):
    """One device's live bytes within a factor of 2 of the reference's
    (the port counts every intermediate unfused), and its fits_16gb."""
    ratio = rec["bytes_per_device_live"] / want["bytes_per_device_live"]
    assert 0.5 <= ratio <= 2.0, (rec["shape"], ratio)
    assert rec["fits_16gb"] == want["fits_16gb"], rec["shape"]


def test_dryrun_single_cell_smoke(tmp_path, ref):
    """The counterpart of tests/test_multidevice.py::test_dryrun_single_cell_smoke:
    the entry point on the 256-device production mesh, with no card."""
    before = os.environ.get(FORCE_ENV)
    out = tmp_path / "dryrun"
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                        "--mesh", "single", "--out", str(out)]) == 0
    assert os.environ.get(FORCE_ENV) == before
    rec = json.loads((out / "llama3_2-1b_decode_32k_single.json").read_text())
    want = ref.result()["records"]["decode_32k"]
    assert set(rec) - set(want) == {"collectives_from"}
    assert set(want) - set(rec) == set()
    assert set(rec["memory"]) == set(want["memory"])
    assert set(rec["roofline"]) == set(want["roofline"])
    assert rec["memory"]["argument_bytes"] == want["memory"]["argument_bytes"]
    assert rec["compile_time_s"] is None and rec["n_chips"] == 256
    assert rec["roofline"]["dominant"] == want["roofline"]["dominant"] == "memory"
    _live_within_2x(rec, want)


def test_optimizer_and_microbatches_equal(ref):
    res = ref.result()
    meshes = {m: _production_mesh(m) for m in MESHES}
    for arch in all_arch_names():
        cfg = get_config(arch)
        assert dryrun.choose_optimizer(cfg)[1] == res["optimizer"][arch]
        for shape in shapes_for(cfg):
            for m, mesh in meshes.items():
                assert (dryrun.choose_microbatches(cfg, shape, mesh)
                        == res["microbatches"][f"{arch}|{shape.name}|{m}"]), (arch, shape, m)


def test_collective_bytes_reads_reference_hlo(ref):
    res = ref.result()
    got = roofline.collective_bytes(ref.hlo.read_text())
    assert got == res["hlo_collectives"]
    assert sum(v["count"] for v in got.values()) > 0


_PRODUCT_AR = re.compile(r"= (.+?) all-reduce(?:-start)?\(.*op_name=\"[^\"]*?/"
                         r"(?:(\w+),(\w+)->\w+/dot_general|(gather))\"")


def test_decode_collectives_equal_reference_hlo(ref):
    """Decode keeps the weights in place: each product whose input dim is
    split all-reduces its float32 partial sums, and the vocab-split lookup
    its rows.  On llama3.2-1b decode_32k at one layer (the reference's
    compiled HLO) those all-reduces, a weight's product or the lookup, byte
    for byte."""
    ref.result()                              # the reference has written its HLO
    want = 0
    for line in ref.hlo.read_text().splitlines():
        m = _PRODUCT_AR.search(line)
        if m and (m.group(4) or "b" not in m.group(3)):    # the rhs is a weight
            want += roofline._shape_bytes(m.group(1))
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=1)
    mesh = _production_mesh("single")
    got = dryrun.plan_collectives(cfg, SHAPES["decode_32k"], plan_for_mesh(mesh), mesh,
                                  MoEOptions.from_config(cfg))
    assert got["all-reduce"]["bytes"] == want > 0
    assert got["all-gather"]["bytes"] == got["reduce-scatter"]["bytes"] == 0


@pytest.mark.parametrize("arch,shape,rounded", [
    ("llama3.2-1b", "train_4k", {"wk", "wv"}), ("llama3.2-1b", "prefill_32k", {"wk", "wv"}),
    ("mamba2-780m", "train_4k", set()),
    ("qwen3-moe-235b-a22b", "train_4k", {"wk", "wv", "router"})])
def test_device_share_holds_the_tensor_axis_shards(arch, shape, rounded):
    """One device's share of a cell on the 16 x 16 mesh: its parameters are
    the tensor axis's shards of the whole config's, but the KV projections
    of fewer KV heads than the axis (rounded up to one head) and the MoE
    router (replicated, over the device's experts only); its batch the
    rows it is given."""
    cfg, mesh = get_config(arch), _production_mesh("single")
    plan = plan_for_mesh(mesh)
    share, shape_dev = dryrun.device_share(cfg, SHAPES[shape], plan, mesh, 3)
    assert shape_dev.global_batch == 3 and shape_dev.seq_len == SHAPES[shape].seq_len
    whole, specs = abstract_params(cfg, plan)
    local, _ = abstract_params(share, plan)
    fsdp = set(plan.fsdp_axes)

    def walk(w, loc, sp, name):
        if isinstance(w, dict):
            assert set(w) == set(loc)
            for k in w:
                walk(w[k], loc[k], sp[k], k)
        elif name not in rounded:
            assert list(loc.shape) == dryrun._shard_shape(w, sp, mesh, skip=fsdp), name
    walk(whole, local, specs, "")


def test_device_share_of_decode_and_one_device():
    """Decode with the KV cache sharded on its sequence: the cache's length
    split, the heads whole; qwen3-moe: a device's experts and ceil(k/tp)
    of each token's top-k; hymba-1.5b: 25 query and 5 KV heads rounded up
    to 2 and 1, its SSM whole (50 heads do not divide by 16); a 1 x 1
    mesh: the cell itself."""
    mesh = _production_mesh("single")
    plan = plan_for_mesh(mesh)
    cfg = get_config("llama3.2-1b")
    share, shape = dryrun.device_share(cfg, SHAPES["decode_32k"], plan, mesh, 8)
    assert (share.n_heads, share.n_kv_heads, share.d_ff, share.vocab) == (
        cfg.n_heads, cfg.n_kv_heads, cfg.d_ff // 16, cfg.vocab // 16)
    assert (shape.seq_len, shape.global_batch) == (32768 // 16, 8)
    moe = get_config("qwen3-moe-235b-a22b")
    share, _ = dryrun.device_share(moe, SHAPES["train_4k"], plan, mesh, 4)
    assert (share.moe_experts, share.moe_topk) == (moe.moe_experts // 16,
                                                   -(-moe.moe_topk // 16))
    hymba = get_config("hymba-1.5b")
    share, _ = dryrun.device_share(hymba, SHAPES["prefill_32k"], plan, mesh, 2)
    assert (share.n_heads, share.n_kv_heads, share.hd) == (2, 1, hymba.hd)
    assert (share.ssm_inner, share.ssm_heads) == (hymba.ssm_inner, hymba.ssm_heads)
    one = types.SimpleNamespace(shape={"data": 1, "model": 1}, axis_names=("data", "model"))
    assert dryrun.device_share(cfg, SHAPES["train_4k"], plan, one, 256) == (
        cfg, SHAPES["train_4k"])


@pytest.mark.parametrize("arch", all_arch_names())
def test_input_specs_equal_reference(arch, ref):
    """Every input's shapes, dtypes and sanitized specs, every shape and mesh."""
    cfg = get_config(arch)
    opt = dryrun.choose_optimizer(cfg)[0]
    specs = ref.result()["specs"]
    for m in MESHES:
        mesh = _production_mesh(m)
        plan = plan_for_mesh(mesh)
        for shape in shapes_for(cfg):
            spec = input_specs(cfg, shape, plan, mesh, opt=opt)
            got = {part: _flat(spec[part],
                               spec["opt_spec" if part == "opt_state" else part + "_spec"], mesh)
                   for part in ("params", "opt_state", "batch", "tok", "state") if part in spec}
            want = specs[f"{arch}|{shape.name}|{m}"]
            assert got == want, (arch, shape.name, m)
            assert all(t.device.type == "meta" for t in
                       dryrun._tensors([spec[p] for p in got]))
