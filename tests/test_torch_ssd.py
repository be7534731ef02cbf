"""The port's SSD scan (``repro_torch.kernels.ssd``) and Mamba-2 layer
(``repro_torch.models.mamba2``) against the JAX package's.

Contract, on the CPU with the plain PyTorch versions, on inputs made with
``np.random.default_rng`` and handed to both packages as NumPy:

- ``ssd_chunked_ref`` (the plain version of the CUDA kernel) against the
  reference's ``ssd_chunked`` at ``atol = rtol = 1e-5`` in float32 (y and
  the final state), and against the serial oracle ``ssd_ref`` and the Pallas
  kernel ``ssd_scan`` in interpret mode at ``2e-3``
  (``tests/test_kernels.py``'s bar); the port's ``ssd_ref`` against the
  reference's;
- the final state against a run of ``ssd_decode_step`` at 1e-3;
- a length that no chunk divides (one chunk of all of S, as ``apply_mamba``
  picks), B/C given per group of heads, and a decay large enough that an
  unmasked ``exp(cum_i - cum_j)`` overflows;
- ``apply_mamba`` (with its decode state) at 1e-4 of its scale and
  ``decode_mamba`` at 1e-5 against the reference's, in float32.

The CUDA kernel runs only on a card: the ``cuda``-marked tests skip here
(``python3 chip_smoke.py`` holds it against the plain version on the card).
What the CPU can check of it: its precision scheme (bf16 hi/lo operands,
three products, float32 sums, at the chunk and P split of ``kernel.plan``),
emulated here on ``chip_smoke.py``'s input distributions and held against
``ssd_chunked_ref`` at the kernel's bars; and its launch plan (shared memory
within ``build.MAX_SMEM_BYTES``, the grid covering BH x P).
"""

import dataclasses
import importlib.util
import pathlib

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

from repro.configs import get_smoke as ref_smoke  # noqa: E402
from repro.kernels.ssd import kernel as pallas  # noqa: E402
from repro.kernels.ssd import ops as ref_ops  # noqa: E402
from repro.kernels.ssd import ref as ref_ref  # noqa: E402
from repro.models import mamba2 as RM  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.kernels.build import MAX_SMEM_BYTES  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.models import mamba2 as PM  # noqa: E402


def _inputs(bh, s, p, n, seed, dt_scale=0.1, a_scale=0.3):
    """x, dt = softplus(N) * dt_scale, a = -exp(N * a_scale), B, C."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, s, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((bh, s)))) * dt_scale).astype(np.float32)
    a = (-np.exp(rng.standard_normal(bh) * a_scale)).astype(np.float32)
    b = rng.standard_normal((bh, s, n)).astype(np.float32)
    c = rng.standard_normal((bh, s, n)).astype(np.float32)
    return x, dt, a, b, c


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


SHAPES = [(128, 32, 16, 32), (256, 64, 32, 64), (256, 64, 128, 128)]


@pytest.mark.parametrize("s,p,n,chunk", SHAPES)
def test_chunked_ref_vs_reference_chunked(s, p, n, chunk):
    ins = _inputs(2, s, p, n, seed=s + n)
    ry, rst = ref_ops.ssd_chunked(*_j(*ins), chunk=chunk, return_state=True)
    py, pst = ssd.ssd_chunked_ref(*_t(*ins), chunk=chunk, return_state=True)
    np.testing.assert_allclose(_np(py), _np(ry), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(pst), _np(rst), atol=1e-5, rtol=1e-5)
    assert torch.equal(ssd.ssd_chunked(*_t(*ins), chunk=chunk), py)


@pytest.mark.parametrize("s,p,n,chunk", SHAPES)
def test_chunked_ref_vs_serial_oracle_and_pallas(s, p, n, chunk):
    ins = _inputs(2, s, p, n, seed=s * n)
    oracle = _np(ref_ops.ssd_reference(*_j(*ins)))
    got = _np(ssd.ssd_chunked_ref(*_t(*ins), chunk=chunk))
    np.testing.assert_allclose(got, oracle, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_np(ssd.ssd_ref(*_t(*ins))), _np(ref_ref.ssd_ref(*_j(*ins))),
                               atol=1e-5, rtol=1e-5)
    tile = pallas.ssd_scan(*_j(*ins), chunk=chunk, interpret=True)
    np.testing.assert_allclose(got, _np(tile), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("chunk", [16, 64])
def test_final_state_matches_decode_steps(chunk):
    bh, s, p, n = 2, 64, 16, 8
    x, dt, a, b, c = _t(*_inputs(bh, s, p, n, seed=7))
    _, final = ssd.ssd_chunked(x, dt, a, b, c, chunk=chunk, return_state=True)
    state = torch.zeros((bh, p, n))
    for t in range(s):
        state, _ = ssd.ssd_decode_step(state, x[:, t], dt[:, t], a, b[:, t], c[:, t])
    np.testing.assert_allclose(_np(final), _np(state), atol=1e-3, rtol=1e-3)
    rs = jnp.zeros((bh, p, n))
    xj, dtj, aj, bj, cj = _j(*(v.numpy() for v in (x, dt, a, b, c)))
    for t in range(3):
        rs, ry = ref_ops.ssd_decode_step(rs, xj[:, t], dtj[:, t], aj, bj[:, t], cj[:, t])
    ps, py = torch.zeros((bh, p, n)), None
    for t in range(3):
        ps, py = ssd.ssd_decode_step(ps, x[:, t], dt[:, t], a, b[:, t], c[:, t])
    np.testing.assert_allclose(_np(ps), _np(rs), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(py), _np(ry), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("s", [57, 131])
def test_non_dividing_length_and_grouped_bc(s):
    """apply_mamba's rule: a length that min(128, S) does not divide is one
    chunk of all of S.  B/C per group of heads give the per-head result."""
    bh, p, n, heads = 4, 32, 16, 2
    x, dt, a, b, c = _inputs(bh, s, p, n, seed=s)
    b[1::2], c[1::2] = b[0::2], c[0::2]              # shared by each pair of heads
    want = _np(ref_ops.ssd_reference(*_j(x, dt, a, b, c)))
    y, st = ssd.ssd_chunked(*_t(x, dt, a, b[::heads], c[::heads]), chunk=s,
                            return_state=True)
    np.testing.assert_allclose(_np(y), want, atol=2e-3, rtol=2e-3)
    ry, rst = ref_ops.ssd_chunked(*_j(x, dt, a, b, c), chunk=s, return_state=True)
    np.testing.assert_allclose(_np(y), _np(ry), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(st), _np(rst), atol=1e-5, rtol=1e-5)


def test_large_decay_is_masked_before_the_exponential():
    """a = -1 and dt near softplus(0): one chunk of 128 passes |sum dt a| ~ 88,
    where exp(cum_i - cum_j) for j > i overflows; the result stays finite."""
    x, dt, _, b, c = _inputs(2, 256, 32, 16, seed=3, dt_scale=1.0)
    a = -np.ones(2, np.float32)
    assert float(dt[:, :128].sum(-1).min()) > 88
    y, st = ssd.ssd_chunked(*_t(x, dt, a, b, c), chunk=128, return_state=True)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    np.testing.assert_allclose(_np(y), _np(ref_ops.ssd_reference(*_j(x, dt, a, b, c))),
                               atol=2e-3, rtol=2e-3)
    # cum reaches ~ -90 inside a chunk: exp(cum_i - cum_j) carries ~|cum|·eps
    # of relative rounding, summed in another order than XLA's cumsum
    ry = ref_ops.ssd_chunked(*_j(x, dt, a, b, c), chunk=128)
    np.testing.assert_allclose(_np(y), _np(ry), atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# the Mamba-2 layer
# --------------------------------------------------------------------------

def _layer(name, seed=0):
    rc = dataclasses.replace(ref_smoke(name), dtype="float32")
    pc = dataclasses.replace(get_smoke(name), dtype="float32")
    arrays = {k[len("layers.ssm."):]: v[0] for k, v in
              convert.seeded_model_arrays(pc, seed).items() if k.startswith("layers.ssm.")}
    rp = {k: jnp.asarray(v.view(jnp.bfloat16) if v.dtype == np.uint16 else v)
          for k, v in arrays.items()}
    pp = convert.model_params(arrays, "cpu")
    return rc, pc, rp, pp


@pytest.mark.parametrize("s", [64, 200, 3])
@pytest.mark.parametrize("name", ["mamba2-780m", "hymba-1.5b"])
def test_apply_mamba_matches_reference(name, s):
    rc, pc, rp, pp = _layer(name)
    x = np.random.default_rng(s).standard_normal((2, s, pc.d_model)).astype(np.float32)
    r_out, r_st = RM.apply_mamba(rp, rc, jnp.asarray(x), return_state=True)
    p_out, p_st = PM.apply_mamba(pp, pc, torch.from_numpy(x), return_state=True)
    # the layer's float32 products and the chunked scan's cumulative sums
    # round in another order than XLA's: 1e-4 of the output's scale
    scale = float(np.abs(_np(r_out)).max())
    np.testing.assert_allclose(_np(p_out), _np(r_out), atol=1e-4 * scale, rtol=1e-4)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(_np(p_st[k]), _np(r_st[k]), atol=1e-4, rtol=1e-4)
    assert torch.equal(PM.apply_mamba(pp, pc, torch.from_numpy(x)), p_out)


def test_decode_mamba_matches_reference():
    rc, pc, rp, pp = _layer("mamba2-780m")
    rng = np.random.default_rng(5)
    r_st = RM.init_mamba_state(rc, 2, jnp.float32)
    p_st = PM.init_mamba_state(pc, 2, torch.float32)
    for k in ("ssm", "conv"):
        assert tuple(p_st[k].shape) == tuple(r_st[k].shape)
    for _ in range(6):
        x = rng.standard_normal((2, 1, pc.d_model)).astype(np.float32)
        r_st, r_y = RM.decode_mamba(rp, rc, r_st, jnp.asarray(x))
        p_st, p_y = PM.decode_mamba(pp, pc, p_st, torch.from_numpy(x))
        np.testing.assert_allclose(_np(p_y), _np(r_y), atol=1e-5, rtol=1e-5)
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(_np(p_st[k]), _np(r_st[k]), atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# device policy, and the kernel on the card
# --------------------------------------------------------------------------

def test_kernel_refuses_cpu_tensors():
    x, dt, a, b, c = _t(*_inputs(2, 64, 32, 16, seed=1))
    n0 = ssd_kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan(x, dt, a, b, c)
    assert ssd_kernel.LAUNCHES == n0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_kernel_vs_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    dev = torch.device("cuda")
    for s, chunk in ((256, 128), (200, 200)):
        x, dt, a, b, c = (t.to(dev) for t in _t(*_inputs(4, s, 64, 128, seed=s)))
        if dtype == "bf16":
            x = x.to(torch.bfloat16)
        n0 = ssd_kernel.LAUNCHES
        y, st = ssd_kernel.ssd_scan(x, dt, a, b, c, return_state=True)
        torch.cuda.synchronize()
        assert ssd_kernel.LAUNCHES == n0 + 1
        wy, wst = ssd.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk, return_state=True)
        torch.testing.assert_close(y.float(), wy.float(), atol=2e-3 if dtype == "f32" else 2e-2,
                                   rtol=2e-3 if dtype == "f32" else 2e-2)
        torch.testing.assert_close(st, wst, atol=2e-3, rtol=2e-3)


# --------------------------------------------------------------------------
# the kernel's precision scheme and launch plan, on the CPU
# --------------------------------------------------------------------------

def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports the standard
    library only)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf(v):
    return v.to(torch.bfloat16).float()


def _mm(a, b, a_exact, b_exact):
    """a @ b (batched) as the kernel's wgmma passes take it: an operand that
    holds float32 digits is split into bf16 hi and lo, and the product is
    hi.hi + hi.lo + lo.hi, each exact in float32 and summed in float32; an
    operand that is bf16 already takes one pass."""
    ah, al = (a, None) if a_exact else (_bf(a), _bf(a - _bf(a)))
    bh, bl = (b, None) if b_exact else (_bf(b), _bf(b - _bf(b)))
    out = ah @ bh
    if bl is not None:
        out = out + ah @ bl
    if al is not None:
        out = out + al @ bh
    return out


def _emulate_kernel(x, dt, a, b, c, heads):
    """``csrc/ssd.cu``'s arithmetic in float32 on the CPU: per head and slice
    of P (``kernel.plan``'s split), chunks of ``kernel.plan``'s length, the
    ragged tail zero; G = C.B^T, M masked before the exponential, Y = M.x,
    Yi = C.state^T scaled by exp(cum) after, the state carried transposed
    and decayed before B^T.(x o w) is added.  Returns y (float32) and the
    final state."""
    bh, s, p = x.shape
    n = b.shape[-1]
    x_exact = x.dtype == torch.bfloat16
    bc_exact = b.dtype == torch.bfloat16
    pl = ssd_kernel.plan(x.dtype, p, n, b.dtype)
    L, ps = pl["chunk"], pl["p_split"]
    nc = -(-s // L)
    pad = nc * L - s
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, pad))
    bf = torch.nn.functional.pad(b.float(), (0, 0, 0, pad)).repeat_interleave(heads, 0)
    cf = torch.nn.functional.pad(c.float(), (0, 0, 0, pad)).repeat_interleave(heads, 0)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool))
    y = torch.zeros((bh, nc * L, p))
    state = torch.zeros((bh, p, n))
    for p0 in range(0, p, ps):
        st_t = torch.zeros((bh, n, ps))                  # state^T slice
        for i in range(nc):
            rows = slice(i * L, (i + 1) * L)
            xs, d = xf[:, rows, p0:p0 + ps], dtf[:, rows]
            bb, cc = bf[:, rows], cf[:, rows]
            cum = torch.cumsum(d * a[:, None], dim=-1)
            total = cum[:, -1:]
            g = _mm(cc, bb.transpose(1, 2), bc_exact, bc_exact)
            diff = torch.where(mask, cum[:, :, None] - cum[:, None, :], 0.0)
            m = torch.where(mask, g * torch.exp(diff) * d[:, None, :], 0.0)
            yv = _mm(m, xs, False, x_exact)
            yi = _mm(cc, st_t, bc_exact, False)
            y[:, rows, p0:p0 + ps] = yv + torch.exp(cum)[:, :, None] * yi
            xw = xs * (torch.exp(total - cum) * d)[:, :, None]
            st_t = st_t * torch.exp(total)[:, :, None] + _mm(bb.transpose(1, 2), xw,
                                                             bc_exact, False)
        state[:, p0:p0 + ps] = st_t.transpose(1, 2)
    return y[:, :s], state


@pytest.mark.parametrize("bc", ["f32", "bf16"])
@pytest.mark.parametrize("xt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [16, 128])
@pytest.mark.parametrize("p", [32, 64, 128])
def test_kernel_precision_scheme_within_the_bars(p, n, xt, bc):
    """The split-bf16 scheme keeps float32's digits: on chip_smoke.py's
    inputs (a = -1, dt = softplus(N): a chunk's log-decay passes -88) at a
    ragged S = 1,000, the emulated kernel is within atol = rtol = 2e-3 of the
    plain version (float32 x), or within atol 2e-3 and rtol 2**-8 once y is
    rounded to bfloat16 (bfloat16 x); the final state within 2e-3."""
    heads, bh, s = 2, 4, 1000
    x, dt, a, b, c = _chip_smoke()._ssd_inputs(bh, heads, s, p, n, "cpu", seed=p + n)
    if xt == "bf16":
        x = x.to(torch.bfloat16)
    if bc == "bf16":
        b, c = b.to(torch.bfloat16), c.to(torch.bfloat16)
    assert float((dt[:, :64] * a[:, None]).sum(-1).max()) < -20
    y, st = _emulate_kernel(x, dt, a, b, c, heads)
    want_y, want_st = ssd.ssd_chunked_ref(
        x.float(), dt, a, b.float().repeat_interleave(heads, 0),
        c.float().repeat_interleave(heads, 0), chunk=200, return_state=True)
    if xt == "f32":
        torch.testing.assert_close(y, want_y, atol=2e-3, rtol=2e-3)
    else:
        torch.testing.assert_close(y.to(torch.bfloat16).float(), want_y, atol=2e-3,
                                   rtol=2.0 ** -8)
    torch.testing.assert_close(st, want_st, atol=2e-3, rtol=2e-3)
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("bc", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plan_fits_and_covers_the_grid(dtype, bc):
    """Every accepted (x dtype, B/C dtype, P, N): the shared memory within
    what a block may use, blocks that cover P, and a state of at least 64
    rows (wgmma's M side)."""
    for p in ssd_kernel.HEAD_DIMS:
        for n in ssd_kernel.STATE_DIMS:
            plan = ssd_kernel.plan(dtype, p, n, bc)
            assert plan["chunk"] == 64
            assert 0 < plan["smem"] <= MAX_SMEM_BYTES
            assert plan["blocks_per_head"] * plan["p_split"] == p
            assert plan["state_rows"] == max(n, 64)
            assert plan["bc_split"] == (bc == torch.float32)
            assert plan["threads"] == 128


def test_chip_smoke_forms_are_accepted_and_split():
    """chip_smoke.py's SSD forms (mamba2-780m's and hymba-1.5b's shapes, a
    ragged length) are all accepted by the kernel and planned with at least
    two blocks a head."""
    for shape, heads, bh, s, p, n, chunk in _chip_smoke().SSD_FORMS:
        assert p in ssd_kernel.HEAD_DIMS and n in ssd_kernel.STATE_DIMS
        for dtype in (torch.float32, torch.bfloat16):
            plan = ssd_kernel.plan(dtype, p, n)
            assert plan["blocks_per_head"] >= 2, shape


@pytest.mark.cuda
@pytest.mark.parametrize("bc", ["f32", "bf16"])
@pytest.mark.parametrize("xt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [16, 128])
@pytest.mark.parametrize("p", [32, 64, 128])
def test_cuda_kernel_matrix_vs_plain(p, n, xt, bc):
    """The kernel against the plain version over the emulation's matrix, at
    a ragged S and with B/C per group of heads, at the kernel's bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    dev = torch.device("cuda")
    heads, bh = 2, 4
    for s in (1000, 57):
        x, dt, a, b, c = _chip_smoke()._ssd_inputs(bh, heads, s, p, n, dev, seed=s + n)
        if xt == "bf16":
            x = x.to(torch.bfloat16)
        if bc == "bf16":
            b, c = b.to(torch.bfloat16), c.to(torch.bfloat16)
        n0 = ssd_kernel.LAUNCHES
        y, st = ssd_kernel.ssd_scan(x, dt, a, b, c, return_state=True)
        torch.cuda.synchronize()
        assert ssd_kernel.LAUNCHES == n0 + 1
        wy, wst = ssd.ssd_chunked_ref(
            x.float(), dt, a, b.float().repeat_interleave(heads, 0),
            c.float().repeat_interleave(heads, 0), chunk=s, return_state=True)
        torch.testing.assert_close(y.float(), wy, atol=2e-3,
                                   rtol=2e-3 if xt == "f32" else 2.0 ** -8)
        torch.testing.assert_close(st, wst, atol=2e-3, rtol=2e-3)
        assert ssd_kernel.wgmma_smem(x.dtype, n, b.dtype) == ssd_kernel.plan(
            x.dtype, p, n, b.dtype)["smem"]


# --------------------------------------------------------------------------
# gradients
# --------------------------------------------------------------------------

def _grads_of(fn, arrays, dy):
    """Autograd of the port's ``fn`` at float32 ``arrays``: their grads."""
    leaves = [t.requires_grad_(True) for t in _t(*arrays)]
    y = fn(*leaves)
    return [g.numpy() for g in torch.autograd.grad(y, leaves, torch.from_numpy(dy))]


@pytest.mark.parametrize("s,chunk,groups", [(128, 32, 1), (96, 96, 2), (64, 64, 4)])
def test_chunked_grads_vs_reference(s, chunk, groups):
    """The port's ssd_chunked (grouped B/C) differentiated by autograd
    against jax.grad of the reference's ssd_chunked (per-head B/C; the
    group's heads' gradients summed), where the reference's gradient is
    finite (each chunk's decay above e^-88)."""
    bh, p, n = 4, 32, 16
    x, dt, a, b, c = _inputs(bh, s, p, n, seed=s + groups)
    b, c = b[:groups], c[:groups]
    dy = np.random.default_rng(s).standard_normal((bh, s, p)).astype(np.float32)
    hpg = bh // groups
    got = _grads_of(lambda *t: ssd.ssd_chunked(*t, chunk=chunk), (x, dt, a, b, c), dy)

    def ref_loss(x_, dt_, a_, b_, c_):
        y = ref_ops.ssd_chunked(x_, dt_, a_, jnp.repeat(b_, hpg, 0), jnp.repeat(c_, hpg, 0),
                                chunk=chunk)
        return jnp.sum(y * dy)
    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4))(*_j(x, dt, a, b, c))
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc"), got, want):
        w = _np(w)
        assert np.isfinite(w).all(), name
        np.testing.assert_allclose(g, w, atol=1e-4 * float(np.abs(w).max()), rtol=1e-4,
                                   err_msg=name)


def test_chunked_grads_finite_where_reference_overflows():
    """At mamba2's init (dt ~ softplus(N), a = -1) a 128-step chunk's decay
    passes e^-88: the reference's ssd_chunked takes exp of the unmasked
    upper triangle, and its gradient is NaN (ROADMAP, queue 3).  The port's
    plain version masks before the exponential: its gradient is finite and
    equals that of the serial recurrence ``ssd_ref`` (the reference's)."""
    bh, s, p, n = 2, 256, 16, 16
    x, dt, a, b, c = _inputs(bh, s, p, n, seed=8, dt_scale=1.0, a_scale=0.0)
    dy = np.random.default_rng(9).standard_normal((bh, s, p)).astype(np.float32)
    got = _grads_of(lambda *t: ssd.ssd_chunked(*t, chunk=128), (x, dt, a, b, c), dy)
    ref_chunked = jax.grad(lambda *t: jnp.sum(ref_ops.ssd_chunked(*t, chunk=128) * dy),
                           argnums=(0, 1, 2, 3, 4))(*_j(x, dt, a, b, c))
    assert not all(np.isfinite(_np(g)).all() for g in ref_chunked)
    serial = jax.grad(lambda *t: jnp.sum(ref_ref.ssd_ref(*t) * dy),
                      argnums=(0, 1, 2, 3, 4))(*_j(x, dt, a, b, c))
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc"), got, serial):
        w = _np(w)
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, atol=1e-3 * float(np.abs(w).max()), rtol=1e-3,
                                   err_msg=name)


def _emulate_bwd(x, dt, a, b, c, dy, hpg, L=64, round_bf16=False):
    """``csrc/ssd_bwd.cu``'s wgmma scheme in float64: each chunk's local
    state deltas dS_c = (x o w)^T B and dE_c = (gy o exp(cum))^T C
    (``ssd_bwd_delta``), the chains over chunks that turn them into the
    chunk-start states S_c and reverse carries E_c (``ssd_bwd_scan``), then
    a walk per (chunk, group) over the group's heads in order, dB and dC
    summed as it goes (``ssd_bwd_chunk_wg``): C.B^T once, W and Q from
    gy.x^T, U from B.E^T, u = f o B.E^T + A^T.gy, T from C.S^T, dcum's sums
    and its reverse scan, and da summed over a head's chunks
    (``ssd_bwd_da``).  With ``round_bf16`` the operands the kernel rounds
    to bfloat16 once are rounded (x o w, gy o exp(cum), A, W, dS_c, dE_c,
    S_c, E_c; ``kernel.plan_bwd``'s ``rounded_to_bf16``).  Inputs
    [BH, S, ..] float64 tensors, b/c [G, S, N]."""
    rnd = (lambda t: t.to(torch.bfloat16).double()) if round_bf16 else (lambda t: t)
    bh, s, p = x.shape
    n, groups = b.shape[-1], b.shape[0]
    nc = -(-s // L)
    pad = nc * L - s
    P = lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad)) if t.dim() == 3 \
        else torch.nn.functional.pad(t, (0, pad))                         # noqa: E731
    xs, gs = P(x).reshape(bh, nc, L, p), P(dy).reshape(bh, nc, L, p)
    bs, cs = P(b).reshape(groups, nc, L, n), P(c).reshape(groups, nc, L, n)
    dts = P(dt).reshape(bh, nc, L)
    hg = torch.arange(bh) // hpg
    cum = torch.cumsum(dts * a[:, None, None], -1)
    total = cum[..., -1]
    f = torch.exp(total[..., None] - cum)                       # f_j
    xw = rnd(xs * (f * dts)[..., None])                          # x o w
    ge = rnd(gs * torch.exp(cum)[..., None])                     # gy o exp(cum)
    # ssd_bwd_delta: the chunks' local deltas
    d_s = rnd(torch.einsum("hcjp,hcjn->hcpn", xw, bs[hg]))
    d_e = rnd(torch.einsum("hcip,hcin->hcpn", ge, cs[hg]))
    # ssd_bwd_scan: the chains over chunks, S forward and E backward
    S, E = torch.zeros_like(d_s), torch.zeros_like(d_e)
    st = torch.zeros(bh, p, n, dtype=x.dtype)
    for ch in range(nc):
        S[:, ch] = rnd(st)
        st = torch.exp(total[:, ch])[:, None, None] * st + d_s[:, ch]
    st = torch.zeros(bh, p, n, dtype=x.dtype)
    for ch in reversed(range(nc)):
        E[:, ch] = rnd(st)
        st = torch.exp(total[:, ch])[:, None, None] * st + d_e[:, ch]
    # ssd_bwd_chunk_wg: a block per (chunk, group) walks the group's heads
    dx, ddt = torch.zeros_like(xs), torch.zeros_like(dts)
    da_part = torch.zeros(bh, nc, dtype=x.dtype)
    db, dc = torch.zeros_like(bs), torch.zeros_like(cs)
    tril = torch.tril(torch.ones(L, L, dtype=torch.bool))
    for ch in range(nc):
        for g in range(groups):
            B_, C_ = bs[g, ch], cs[g, ch]
            cb = C_ @ B_.T
            for h in range(g * hpg, (g + 1) * hpg):
                X, GY, cm, dd = xs[h, ch], gs[h, ch], cum[h, ch], dts[h, ch]
                Sh, Eh, fh = S[h, ch], E[h, ch], f[h, ch]
                ex = torch.where(tril, torch.exp(torch.where(tril, cm[:, None] - cm[None], 0.)),
                                 0.)
                W = ex * dd[None] * (GY @ X.T)
                A = cb * ex
                Q = cb * W
                db[g, ch] += rnd(W).T @ C_ + xw[h, ch] @ Eh
                dc[g, ch] += rnd(W) @ B_ + ge[h, ch] @ Sh
                ue = B_ @ Eh.T
                U = dd * fh * (X * ue).sum(1)
                u = fh[:, None] * ue + rnd(A).T @ GY
                dx[h, ch] = dd[:, None] * u
                T = torch.exp(cm) * (GY * (C_ @ Sh.T)).sum(1)
                dcum = Q.sum(1) - Q.sum(0) + T - U
                dcum[-1] += U.sum() + torch.exp(total[h, ch]) * (Eh * Sh).sum()
                lam = torch.flip(torch.cumsum(torch.flip(dcum, [0]), 0), [0])
                ddt[h, ch] = (X * u).sum(1) + a[h] * lam
                da_part[h, ch] = (dd * lam).sum()
    # ssd_bwd_da
    da = da_part.sum(1)
    flat = lambda t: t.reshape(t.shape[0], nc * L, *t.shape[3:])[:, :s]   # noqa: E731
    return flat(dx), ddt.reshape(bh, nc * L)[:, :s], da, flat(db), flat(dc)


@pytest.mark.parametrize("s,groups", [(192, 1), (100, 2), (64, 4)])
def test_bwd_kernel_scheme_vs_plain_autograd(s, groups):
    """The backward kernel's arithmetic (``_emulate_bwd``: 64-step chunks,
    the chunks' local deltas, the chains over chunks, the per-group head
    walk; a ragged tail at S 100) against autograd of the plain version, at
    mamba2's init's decays (no chunk of the plain version overflows at
    chunk 32)."""
    bh, p, n = 4, 32, 16
    x, dt, a, b, c = _inputs(bh, s, p, n, seed=s * groups, dt_scale=0.5, a_scale=0.5)
    b, c = b[:groups], c[:groups]
    dy = np.random.default_rng(s).standard_normal((bh, s, p)).astype(np.float32)
    chunk = 4 if s == 100 else 32
    want = _grads_of(lambda *t: ssd.ssd_chunked(*t, chunk=chunk), (x, dt, a, b, c), dy)
    got = _emulate_bwd(*(torch.from_numpy(v).double() for v in (x, dt, a, b, c, dy)),
                       hpg=bh // groups)
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * float(np.abs(w).max()),
                                   rtol=1e-4, err_msg=name)


def test_bwd_kernel_refuses_cpu_and_grad_inputs():
    x, dt, a, b, c = _t(*_inputs(2, 64, 32, 16, seed=0))
    dy = torch.zeros_like(x)
    n0 = ssd_kernel.BWD_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan_bwd(x, dt, a, b[:1], c[:1], dy)
    with pytest.raises(RuntimeError, match="requires a gradient"):
        ssd_kernel.ssd_scan(x.requires_grad_(True), dt, a, b[:1], c[:1])
    assert ssd_kernel.BWD_LAUNCHES == n0
    # the scratch the kernel takes.  The FMA path: S_c and E_c in float32,
    # per-head dB/dC, da's parts; the wgmma path (bf16 x, B and C at P 64,
    # N 128): the deltas, then S_c and E_c, in bf16 (two to a float32
    # word), each chunk's cum and dt, da's parts: ~195 MiB at mamba2-780m's
    # training shape, against ~806 MiB
    assert ssd_kernel.bwd_scratch_floats(48, 8192, 64, 128) == (
        2 * 48 * 128 * 64 * 128 + 2 * 48 * 8192 * 128 + 48 * 128)
    bf = torch.bfloat16
    words = ssd_kernel.bwd_scratch_floats(48, 8192, 64, 128, bf, bf)
    assert words == 48 * 128 * 64 * 128 + 48 * 128 * 2 * 64 + 48 * 128
    assert words * 4 < 300e6


def test_bwd_kernel_bf16_scheme_within_the_bars():
    """The wgmma path's rounding (``_emulate_bwd(round_bf16=True)``: every
    operand that holds float32 digits rounded to bfloat16 once) on
    chip_smoke.py's inputs (mamba2's init: dt = softplus(N), a = -1, so a
    chunk's log-decay passes -20) with x, B, C and the incoming gradient in
    bfloat16, at a ragged S = 1,000 and two groups of heads: dx, dB and dC
    rounded to bfloat16 once, every output within SSD_BWD_TOL["bf16"] of
    autograd of the plain version in float32, as chip_smoke.py holds the
    card."""
    cs = _chip_smoke()
    heads, bh, s, p, n = 4, 8, 1000, 64, 128
    x, dt, a, b, c = cs._ssd_inputs(bh, heads, s, p, n, "cpu", seed=11)
    assert float((dt[:, :64] * a[:, None]).sum(-1).max()) < -20
    x, b, c = x.bfloat16(), b.bfloat16(), c.bfloat16()
    dy = (torch.randn((bh, s, p), generator=torch.Generator().manual_seed(12)) * 0.1).bfloat16()
    leaves = [t.detach().float().clone().requires_grad_(True) for t in (x, dt, a, b, c)]
    y = ssd.ssd_chunked_ref(leaves[0], leaves[1], leaves[2],
                            torch.repeat_interleave(leaves[3], heads, 0),
                            torch.repeat_interleave(leaves[4], heads, 0), chunk=200)
    want = torch.autograd.grad(y, leaves, dy.float())
    got = _emulate_bwd(*(t.double() for t in (x, dt, a, b, c, dy)), hpg=heads,
                       round_bf16=True)
    out_dtypes = (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16, torch.bfloat16)
    got = [g.to(d) for g, d in zip(got, out_dtypes)]
    tol = cs.SSD_BWD_TOL["bf16"]
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc"), got, want):
        assert torch.isfinite(g).all(), name
        share = cs._grad_share([g], [w], *tol)
        assert share <= 1.0, (name, share)


@pytest.mark.parametrize("s", [64, 1000, 8192])
@pytest.mark.parametrize("bc", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xt", [torch.float32, torch.bfloat16])
def test_bwd_plan_fits_and_covers_the_grid(xt, bc, s):
    """``plan_bwd`` for every accepted (x dtype, B/C dtype, P, N): the wgmma
    path exactly for bfloat16 x, B and C at P 64, N 128; every launch's
    shared memory within what a block may use; grids that cover every
    (chunk, head) and (chunk, group) (the chunk kernels), every head's P x
    N state in 8-element lanes, twice (the chains), and every head (da)."""
    bh, groups = 96, 2
    nc = -(-s // 64)
    for p in ssd_kernel.HEAD_DIMS:
        for n in ssd_kernel.STATE_DIMS:
            plan = ssd_kernel.plan_bwd(xt, bc, p, n, s, bh=bh, groups=groups)
            wgmma = xt == bc == torch.bfloat16 and (p, n) == (64, 128)
            assert plan["path"] == ("wgmma" if wgmma else "fma")
            assert plan["nc"] == nc and plan["chunk_steps"] == ssd_kernel.CHUNK
            assert all(0 <= v <= MAX_SMEM_BYTES for v in plan["smem"].values())
            assert set(plan["grid"]) == set(plan["launches"]) == set(plan["threads"])
            grid = plan["grid"]
            if wgmma:
                assert plan["launches"] == ("delta", "scan", "chunk", "da")
                assert grid["delta"] == (nc, bh) and grid["chunk"] == (nc, groups)
                assert grid["scan"][1] == 2
                assert grid["scan"][0] * plan["threads"]["scan"] * 8 >= bh * p * n
                assert grid["da"][0] * plan["threads"]["da"] >= bh
                assert plan["threads"]["chunk"] == 128 and plan["stages"] >= 2
                assert set(plan["rounded_to_bf16"]) == {
                    "x o w", "gy o exp(cum)", "A", "W", "dS_c", "dE_c", "S_c", "E_c"}
            else:
                assert plan["launches"] == ("states", "chunk", "reduce")
                assert grid["states"] == (bh, p // 16, 2) and grid["chunk"] == (nc, bh)
                assert plan["rounded_to_bf16"] == ()


@pytest.mark.parametrize("form", _chip_smoke().SSD_BWD_FORMS, ids=lambda f: f"{f[0]}-{f[1]}")
def test_chip_smoke_bwd_forms_are_accepted(form):
    _, _, heads, bh, s, p, n, chunk, _, _ = form
    assert p in ssd_kernel.HEAD_DIMS and n in ssd_kernel.STATE_DIMS
    assert bh % heads == 0 and s % chunk == 0


@pytest.mark.cuda
@pytest.mark.parametrize("bc", ["f32", "bf16"])
@pytest.mark.parametrize("xt", ["f32", "bf16"])
def test_cuda_bwd_kernel_vs_plain(xt, bc):
    """SSDScanFn on the card (its backward: the gradient kernel) against
    autograd of the plain version in float32, at chip_smoke.py's bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    for s, groups in ((256, 1), (200, 2)):
        ins = _inputs(4, s, 64, 128, seed=s, dt_scale=0.5, a_scale=0.5)
        x, dt, a, b, c = (t.to(dev) for t in _t(*ins))
        b, c = b[:groups], c[:groups]
        dy = torch.randn(x.shape, device=dev)
        xd = torch.float32 if xt == "f32" else torch.bfloat16
        bd = torch.float32 if bc == "f32" else torch.bfloat16
        leaves = [x.to(xd), dt, a, b.to(bd), c.to(bd)]
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        n0 = ssd_kernel.BWD_LAUNCHES
        y = ssd.ssd_chunked(*leaves)
        got = torch.autograd.grad(y, leaves, dy.to(xd))
        assert ssd_kernel.BWD_LAUNCHES == n0 + 1
        plain = [t.detach().float().requires_grad_(True) for t in leaves]
        hpg = 4 // groups
        yp = ssd.ssd_chunked_ref(plain[0], plain[1], plain[2],
                                 torch.repeat_interleave(plain[3], hpg, 0),
                                 torch.repeat_interleave(plain[4], hpg, 0), chunk=8)
        want = torch.autograd.grad(yp, plain, dy.to(xd).float())
        tol = cs.SSD_BWD_TOL["bf16" if "bf16" in (xt, bc) else "f32"]
        assert cs._grad_share(got, want, *tol) <= 1.0, (xt, bc, s)


@pytest.mark.cuda
def test_cuda_bwd_kernel_is_deterministic():
    """Two gradient calls on the same inputs give bitwise-equal dx, d(dt),
    da, dB and dC on the wgmma path (dB and dC summed over a group's heads
    in a fixed order, no atomics) and on the FMA path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    dev = torch.device("cuda")
    for xt, s in ((torch.bfloat16, 1000), (torch.bfloat16, 256), (torch.float32, 200)):
        ins = _inputs(8, s, 64, 128, seed=s, dt_scale=0.5, a_scale=0.5)
        x, dt, a, b, c = (t.to(dev) for t in _t(*ins))
        x, b, c = x.to(xt), b[:2].to(xt).contiguous(), c[:2].to(xt).contiguous()
        dy = torch.randn(x.shape, device=dev).to(xt)
        w0 = ssd_kernel.BWD_LAUNCHES_WGMMA
        first = ssd_kernel.ssd_scan_bwd(x, dt, a, b, c, dy)
        second = ssd_kernel.ssd_scan_bwd(x, dt, a, b, c, dy)
        torch.cuda.synchronize()
        assert ssd_kernel.BWD_LAUNCHES_WGMMA == w0 + 2 * (xt == torch.bfloat16)
        for name, u, v in zip(("dx", "ddt", "da", "db", "dc"), first, second):
            assert torch.equal(u, v), (name, xt, s)
