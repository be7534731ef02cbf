"""The Mamba-2 mixer's fused glue (``repro_torch.kernels.mamba_glue``).

Contract, on the CPU with the plain versions:

- the float32 gradients of ``ref.py`` (``*_bwd_ref``, the card kernels'
  oracle) hold to autograd of the plain forwards (``ref.conv_silu_heads_ref``
  and ``ref.skip_gate_norm_ref``, which ``apply_mamba`` runs on the CPU)
  within 1e-4 of each gradient's norm in float32 and 1e-2 in bfloat16
  (autograd rounds the conv's per-tap gradients of xi to bfloat16 one by
  one, the kernel once), at the smoke widths (H 8, P 32), hymba-1.5b's (H
  50, P 64), a K of 2 and S < K;
- ``apply_mamba`` on CPU tensors takes the plain code and moves no counter;
  its prefill's conv tail is the conv's last K-1 rows in token order;
- the ops on CPU tensors are the plain statements, on meta tensors their
  shapes (the dry-run);
- the wrappers refuse what the kernels do not take (device, dtype, shape,
  alignment, contiguity, a gradient under grad mode) before any launch.

The kernels run only on a card: the ``cuda``-marked tests skip here (run them
with ``JAX_PLATFORMS=cpu PYTHONPATH=src python3 -m pytest -q -m cuda
tests/test_torch_mamba_glue.py``; ``python3 chip_smoke.py`` times them).  On
the card, at mamba2-780m's training shape (B 6, S 8,192, H 48, P 64),
hymba's H 50, a ragged S of 1,000 and S < K, in bfloat16 and float32: the
forwards within 1 ulp of the plain code (bfloat16; 8 float32 ulps in
float32), the gradients within 1e-2 / 1e-5 of autograd of the plain code in
norm, two gradient calls bitwise equal; a mamba stack's gradients bitwise
the same with ``remat="block"`` and without, and from one call to the next,
with each of the four kernels launched on every layer; a form past the
kernels' limits (K 5, P 12, di 5,120) raises, whether the wrapper or
``apply_mamba`` meets it, and launches nothing.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import mamba_glue
from repro_torch.kernels.mamba_glue import kernel as mk
from repro_torch.kernels.mamba_glue import ref
from repro_torch.models import SINGLE_POD_PLAN
from repro_torch.models import mamba2 as PM
from repro_torch.models.layers import matmul
from repro_torch.models import transformer as T

BF16, F32 = torch.bfloat16, torch.float32
#: (B, S, H, P, K): the smoke widths, hymba-1.5b's heads, K 2, S < K
CPU_FORMS = ((2, 37, 8, 32, 4), (1, 21, 50, 64, 4), (2, 9, 4, 16, 2), (2, 3, 4, 8, 4))
#: a gradient's distance from autograd of the plain code, over its norm, on
#: the card; on the CPU float32 gets 1e-4 (one run of the suite read 1.01e-5
#: for dxi, which reruns never repeated; the CPU's vectorised exp and sums
#: are not the card's)
GRAD_TOL = {F32: 1e-5, BF16: 1e-2}
CPU_GRAD_TOL = {F32: 1e-4, BF16: 1e-2}
EPS = 1e-5


def _rel(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def _conv_inputs(b, s, h, p, k, dtype, dev="cpu", seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    xi = torch.randn((b, s, h * p), generator=g, device=dev).to(dtype)
    w = torch.randn((h * p, k), generator=g, device=dev) * 0.3
    dxh = torch.randn((b * h, s, p), generator=g, device=dev).to(dtype)
    return xi, w, dxh


def _norm_inputs(b, s, h, p, dtype, dev="cpu", seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    y, xh = (torch.randn((b * h, s, p), generator=g, device=dev).to(dtype) for _ in range(2))
    z, dout = (torch.randn((b, s, h * p), generator=g, device=dev).to(dtype) for _ in range(2))
    dskip = torch.randn((h,), generator=g, device=dev)
    norm_g = 1.0 + 0.1 * torch.randn((h * p,), generator=g, device=dev)
    return y, xh, z, dskip, norm_g, dout


def _plain_conv(xi, w, h):
    return ref.conv_silu_heads_ref(xi, w, h)


def _plain_norm(y, xh, z, dskip, norm_g, eps=EPS):
    return ref.skip_gate_norm_ref(y, xh, z, dskip, norm_g, eps)


def _leaves(*ts):
    return [t.detach().clone().requires_grad_(True) for t in ts]


# --------------------------------------------------------------------------
# the plain statements, on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", CPU_FORMS, ids=lambda f: "B{}S{}H{}P{}K{}".format(*f))
@pytest.mark.parametrize("fn", ["conv_silu_heads", "skip_gate_norm"])
def test_ref_gradients_vs_autograd_of_the_plain_code(fn, form, dtype):
    b, s, h, p, k = form
    if fn == "conv_silu_heads":
        xi, w, dxh = _conv_inputs(b, s, h, p, k, dtype, seed=1)
        leaves = _leaves(xi, w)
        want = torch.autograd.grad(_plain_conv(*leaves, h), leaves, dxh)
        got = ref.conv_silu_heads_bwd_ref(xi, w, dxh)
        assert got[0].dtype == dtype and got[1].dtype == F32
    else:
        *args, dout = _norm_inputs(b, s, h, p, dtype, seed=1)
        leaves = _leaves(*args)
        want = torch.autograd.grad(_plain_norm(*leaves), leaves, dout)
        got = ref.skip_gate_norm_bwd_ref(dout, *args, EPS)
        assert [g.dtype for g in got] == [dtype] * 3 + [F32] * 2
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        assert _rel(g, w_) <= CPU_GRAD_TOL[dtype], (fn, _rel(g, w_))


def _counters():
    """(conv forward, conv gradient, gate norm forward, gate norm gradient)
    launches."""
    return mk.CONV_LAUNCHES, mk.CONV_BWD_LAUNCHES, mk.NORM_LAUNCHES, mk.NORM_BWD_LAUNCHES


def _form_counters():
    """(conv with a bias, its gradient, grouped gate norm, its gradient)
    launches."""
    return (mk.CONV_BIAS_LAUNCHES, mk.CONV_BIAS_BWD_LAUNCHES, mk.NORM_GROUPED_LAUNCHES,
            mk.NORM_GROUPED_BWD_LAUNCHES)


#: (B, S, H, P, K, groups): Nemotron-H's x at smoke width (8 heads, 2 groups),
#: its B and C (heads = groups, P = N), K 2, S < K, one group
CPU_NEW_FORMS = ((2, 37, 8, 16, 4, 2), (2, 21, 2, 32, 4, 2), (1, 9, 4, 16, 2, 4),
                 (2, 3, 4, 8, 4, 1))


def _bias(h, p, dev="cpu", seed=0):
    g = torch.Generator(dev).manual_seed(seed + 99)
    return 0.3 * torch.randn((h * p,), generator=g, device=dev)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", CPU_NEW_FORMS, ids=lambda f: "B{}S{}H{}P{}K{}G{}".format(*f))
@pytest.mark.parametrize("fn", ["conv_silu_heads_bias", "skip_gate_norm_groups"])
def test_ref_gradients_with_bias_and_groups_vs_autograd(fn, form, dtype):
    """The plain gradients of the conv with a bias (its gradient a sum over
    rows) and of the gate norm over groups hold to autograd of the plain
    forwards, at CPU_GRAD_TOL as the forms without them."""
    b, s, h, p, k, groups = form
    if fn == "conv_silu_heads_bias":
        xi, w, dxh = _conv_inputs(b, s, h, p, k, dtype, seed=2)
        bias = _bias(h, p)
        leaves = _leaves(xi, w, bias)
        want = torch.autograd.grad(ref.conv_silu_heads_ref(leaves[0], leaves[1], h, leaves[2]),
                                   leaves, dxh)
        got = ref.conv_silu_heads_bwd_ref(xi, w, dxh, bias)
        assert [g.dtype for g in got] == [dtype, F32, F32]
    else:
        *args, dout = _norm_inputs(b, s, h, p, dtype, seed=2)
        leaves = _leaves(*args)
        want = torch.autograd.grad(ref.skip_gate_norm_ref(*leaves, EPS, groups), leaves, dout)
        got = ref.skip_gate_norm_bwd_ref(dout, *args, EPS, groups)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        assert _rel(g, w_) <= CPU_GRAD_TOL[dtype], (fn, _rel(g, w_))


def test_grouped_norm_is_the_norm_of_each_group():
    """With G groups the gated norm of a row is the one-group gated norm of
    each of its G slices, side by side (gain ones)."""
    y, xh, z, dskip, _, _ = _norm_inputs(2, 11, 8, 16, F32)
    ones = torch.ones(8 * 16)
    got = ref.skip_gate_norm_ref(y, xh, z, dskip, ones, EPS, 4)
    u = ref.to_tokens(y + xh * dskip[None, :, None, None].expand(2, 8, 11, 16).reshape(y.shape),
                      2)
    want = torch.cat([ref.gated_norm(u[..., i:i + 32], z[..., i:i + 32], ones[:32], EPS, F32)
                      for i in range(0, 128, 32)], -1)
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("return_state", [False, True])
def test_apply_mamba_on_the_cpu_takes_the_plain_code(return_state):
    cfg = get_smoke("mamba2-780m")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, SINGLE_POD_PLAN)
    lp = {k: v[0].detach().requires_grad_(True) for k, v in params["layers"]["ssm"].items()}
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(2))
    before = _counters()
    out = PM.apply_mamba(lp, cfg, x, return_state=return_state)
    out = out[0] if return_state else out
    out.float().square().sum().backward()
    assert _counters() == before


@pytest.mark.parametrize("s", [16, 2], ids=["S16", "S2_under_K"])
def test_apply_mamba_prefill_conv_tail_is_the_convs_last_rows(s):
    cfg = get_smoke("mamba2-780m")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, SINGLE_POD_PLAN)
    lp = {k: v[0] for k, v in params["layers"]["ssm"].items()}
    x = torch.randn((2, s, cfg.d_model), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        _, state = PM.apply_mamba(lp, cfg, x, return_state=True)
    k1 = cfg.ssm_conv - 1
    xi = matmul(x, lp["wx"])
    xc = F.silu(ref.causal_conv(xi, lp["conv_w"]).to(F32)).to(xi.dtype)
    want = xc[:, -k1:] if s >= k1 else F.pad(xc, (0, 0, k1 - s, 0))
    assert state["conv"].shape == (2, k1, cfg.ssm_inner)
    assert torch.equal(state["conv"], want)


def test_cpu_ops_are_the_plain_statements():
    xi, w, _ = _conv_inputs(2, 11, 4, 16, 4, BF16)
    assert torch.equal(mamba_glue.conv_silu_heads(xi, w, 4), ref.conv_silu_heads_ref(xi, w, 4))
    y, xh, z, dskip, norm_g, _ = _norm_inputs(2, 11, 4, 16, BF16)
    assert torch.equal(mamba_glue.skip_gate_norm(y, xh, z, dskip, norm_g, EPS),
                       ref.skip_gate_norm_ref(y, xh, z, dskip, norm_g, EPS))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_ops_on_meta_tensors_give_the_plain_shapes(dtype):
    b, s, h, p, k = 6, 8192, 48, 64, 4
    xi = torch.empty((b, s, h * p), dtype=dtype, device="meta")
    w = torch.empty((h * p, k), device="meta")
    xh = mamba_glue.conv_silu_heads(xi, w, h)
    assert (xh.device.type, xh.dtype, tuple(xh.shape)) == ("meta", dtype, (b * h, s, p))
    z = torch.empty_like(xi)
    dskip, norm_g = torch.empty(h, device="meta"), torch.empty(h * p, device="meta")
    out = mamba_glue.skip_gate_norm(xh, xh, z, dskip, norm_g, EPS)
    assert (out.device.type, out.dtype, tuple(out.shape)) == ("meta", dtype, (b, s, h * p))


def _bad_calls():
    """(name, call, message) for each input the wrappers must refuse."""
    xi, w, dxh = _conv_inputs(2, 8, 4, 16, 4, BF16)
    y, xh, z, dskip, norm_g, dout = _norm_inputs(2, 8, 4, 16, BF16)
    rstd = torch.ones(16)
    odd = torch.empty(xi.numel() + 1, dtype=BF16)[1:].view(xi.shape)
    return [
        ("cpu", lambda: mk.conv_silu_heads(xi, w, 4), "CUDA"),
        ("cpu_bwd", lambda: mk.conv_silu_heads_bwd(xi, w, dxh), "CUDA"),
        ("cpu_norm", lambda: mk.skip_gate_norm(y, xh, z, dskip, norm_g, EPS), "CUDA"),
        ("cpu_norm_bwd", lambda: mk.skip_gate_norm_bwd(dout, y, xh, z, dskip, norm_g, rstd),
         "CUDA"),
        ("float16", lambda: mk.conv_silu_heads(xi.half(), w, 4), "dtype"),
        ("w_bf16", lambda: mk.conv_silu_heads(xi, w.to(BF16), 4), "dtype"),
        ("misaligned", lambda: mk.conv_silu_heads(odd, w, 4), "16-byte"),
        ("strided", lambda: mk.conv_silu_heads(xi.transpose(0, 1), w, 4), "contiguous"),
        ("dxh_shape", lambda: mk.conv_silu_heads_bwd(xi, w, dxh[:, :4]), "shape"),
        ("z_dtype", lambda: mk.skip_gate_norm(y, xh, z.float(), dskip, norm_g, EPS), "dtype"),
        ("norm_g_bf16", lambda: mk.skip_gate_norm(y, xh, z, dskip, norm_g.to(BF16), EPS),
         "dtype"),
        ("heads", lambda: mk.skip_gate_norm(y[:7], xh[:7], z, dskip, norm_g, EPS), "rows"),
        ("dout_dtype", lambda: mk.skip_gate_norm_bwd(dout.float(), y, xh, z, dskip, norm_g,
                                                     rstd), "dtype"),
        ("grad", lambda: mk.conv_silu_heads(xi, w.requires_grad_(True), 4), "gradient"),
        ("bias_shape", lambda: mk.conv_silu_heads(xi, w, 4, torch.zeros(63)), "shape"),
        ("bias_bf16", lambda: mk.conv_silu_heads(xi, w, 4, torch.zeros(64, dtype=BF16)),
         "dtype"),
        ("groups", lambda: mk.skip_gate_norm(y, xh, z, dskip, norm_g, EPS, 3), "groups"),
        ("rstd_groups", lambda: mk.skip_gate_norm_bwd(dout, y, xh, z, dskip, norm_g, rstd, 2),
         "shape"),
    ]


@pytest.mark.parametrize("case", range(len(_bad_calls())),
                         ids=[c[0] for c in _bad_calls()])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    name, call, message = _bad_calls()[case]
    before = _counters()
    with pytest.raises((ValueError, RuntimeError), match=message):
        call()
    assert _counters() == before, name


def test_chip_smoke_forms_are_the_configs_mixers():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    arch = {"mamba": "mamba2-780m", "hymba": "hymba-1.5b"}
    for form, (_, _, h, p, k, dtype) in cs.GLUE_FORMS.items():
        cfg = get_config(arch[form.split("_")[0]])
        assert (h, p, k) == (cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_conv), form
        assert dtype in ("bf16", "f32"), form
    for name in cs.GLUE_KERNELS:
        assert cs.KERNELS[name]["main"][0] in cs.GLUE_FORMS, name


# --------------------------------------------------------------------------
# the kernels on the card
# --------------------------------------------------------------------------

#: (B, S, H, P, K): mamba2-780m's training shape, hymba-1.5b's H 50, a
#: ragged S, S < K, the widest di the gate norm takes (4,096)
CARD_FORMS = ((6, 8192, 48, 64, 4), (1, 2048, 50, 64, 4), (2, 1000, 48, 64, 4),
              (3, 3, 48, 64, 4), (2, 500, 64, 64, 4))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    return torch.device("cuda")


def _ulps(got, want, dtype) -> float:
    """The largest |got - want| in units of the last place of the larger of
    the two (bfloat16's 8 bits or float32's 24)."""
    bits = 8 if dtype == BF16 else 24
    got, want = got.detach().double(), want.detach().double()
    big = torch.maximum(got.abs(), want.abs())
    _, e = torch.frexp(big)
    ulp = torch.ldexp(torch.ones_like(big), (e - bits).clamp(min=-126 - bits))
    return float(((got - want).abs() / ulp).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("form", CARD_FORMS, ids=lambda f: "B{}S{}H{}P{}K{}".format(*f))
def test_cuda_glue_vs_plain(form, dtype):
    dev = _cuda()
    b, s, h, p, k = form
    fwd_ulps = 1 if dtype == BF16 else 8
    xi, w, dxh = _conv_inputs(b, s, h, p, k, dtype, dev, seed=s)
    leaves = _leaves(xi, w)
    n0 = _counters()
    got = mamba_glue.conv_silu_heads(*leaves, h)
    gw = torch.autograd.grad(got, leaves, dxh)
    torch.cuda.synchronize()
    assert _counters() == (n0[0] + 1, n0[1] + 1, n0[2], n0[3])
    leaves = _leaves(xi, w)
    want = _plain_conv(*leaves, h)
    ww = torch.autograd.grad(want, leaves, dxh)
    assert _ulps(got, want, dtype) <= fwd_ulps
    for g, w_ in zip(gw, ww):
        assert _rel(g, w_) <= GRAD_TOL[dtype]
    del got, want, gw, ww, leaves
    *args, dout = _norm_inputs(b, s, h, p, dtype, dev, seed=s + 1)
    leaves = _leaves(*args)
    got = mamba_glue.skip_gate_norm(*leaves, EPS)
    gn = torch.autograd.grad(got, leaves, dout)
    leaves = _leaves(*args)
    want = _plain_norm(*leaves)
    wn = torch.autograd.grad(want, leaves, dout)
    assert _ulps(got, want, dtype) <= fwd_ulps
    for g, w_ in zip(gn, wn):
        assert _rel(g, w_) <= GRAD_TOL[dtype]
    assert _counters() == (n0[0] + 1, n0[1] + 1, n0[2] + 1, n0[3] + 1)


#: (B, S, H, P, K, bias, groups): Nemotron-3-Nano's x (64 heads of 64, a
#: bias, the norm over 8 groups) at its cell's shape and a ragged one, and
#: its B and C (8 groups, P = N = 128: the conv alone) at the cell's shape
CARD_NEW_FORMS = ((4, 8192, 64, 64, 4, True, 8), (2, 1000, 64, 64, 4, True, 8),
                  (4, 8192, 8, 128, 4, True, 0), (3, 3, 64, 64, 4, True, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("form", CARD_NEW_FORMS,
                         ids=lambda f: "B{}S{}H{}P{}K{}bias{:d}G{}".format(*f))
def test_cuda_glue_bias_and_groups_vs_plain(form, dtype):
    """The conv with a bias and the gate norm over groups against the plain
    code, as ``test_cuda_glue_vs_plain`` holds the first forms; each
    launch counted once by its kernel's counter and its form's (groups 0:
    the conv alone, as B and C take it)."""
    dev = _cuda()
    b, s, h, p, k, _, groups = form
    fwd_ulps = 1 if dtype == BF16 else 8
    xi, w, dxh = _conv_inputs(b, s, h, p, k, dtype, dev, seed=s)
    leaves = _leaves(xi, w, _bias(h, p, dev))
    n0, f0 = _counters(), _form_counters()
    got = mamba_glue.conv_silu_heads(leaves[0], leaves[1], h, leaves[2])
    gw = torch.autograd.grad(got, leaves, dxh)
    torch.cuda.synchronize()
    assert _counters() == (n0[0] + 1, n0[1] + 1, n0[2], n0[3])
    assert _form_counters() == (f0[0] + 1, f0[1] + 1, f0[2], f0[3])
    leaves = _leaves(xi, w, _bias(h, p, dev))
    want = ref.conv_silu_heads_ref(leaves[0], leaves[1], h, leaves[2])
    ww = torch.autograd.grad(want, leaves, dxh)
    assert _ulps(got, want, dtype) <= fwd_ulps
    for g, w_ in zip(gw, ww):
        assert _rel(g, w_) <= GRAD_TOL[dtype]
    del got, want, gw, ww, leaves
    if not groups:
        return
    *args, dout = _norm_inputs(b, s, h, p, dtype, dev, seed=s + 1)
    leaves = _leaves(*args)
    got = mamba_glue.skip_gate_norm(*leaves, EPS, groups)
    gn = torch.autograd.grad(got, leaves, dout)
    leaves = _leaves(*args)
    want = ref.skip_gate_norm_ref(*leaves, EPS, groups)
    wn = torch.autograd.grad(want, leaves, dout)
    assert _ulps(got, want, dtype) <= fwd_ulps
    for g, w_ in zip(gn, wn):
        assert _rel(g, w_) <= GRAD_TOL[dtype]
    grouped = int(groups > 1)
    assert _counters() == (n0[0] + 1, n0[1] + 1, n0[2] + 1, n0[3] + 1)
    assert _form_counters() == (f0[0] + 1, f0[1] + 1, f0[2] + grouped, f0[3] + grouped)


@pytest.mark.cuda
def test_cuda_glue_bias_and_groups_gradients_are_deterministic():
    dev = _cuda()
    b, s, h, p, k = 2, 1000, 64, 64, 4
    xi, w, dxh = _conv_inputs(b, s, h, p, k, BF16, dev)
    bias = _bias(h, p, dev)
    one, two = mk.conv_silu_heads_bwd(xi, w, dxh, bias), mk.conv_silu_heads_bwd(xi, w, dxh, bias)
    assert len(one) == 3 and all(torch.equal(a, c) for a, c in zip(one, two))
    y, xh, z, dskip, norm_g, dout = _norm_inputs(b, s, h, p, BF16, dev)
    _, rstd = mk.skip_gate_norm(y, xh, z, dskip, norm_g, EPS, 8)
    one = mk.skip_gate_norm_bwd(dout, y, xh, z, dskip, norm_g, rstd, 8)
    two = mk.skip_gate_norm_bwd(dout, y, xh, z, dskip, norm_g, rstd, 8)
    assert all(torch.equal(a, c) for a, c in zip(one, two))


@pytest.mark.cuda
def test_cuda_refuses_groups_that_are_not_whole_warps():
    """Groups of 128 channels (16 threads) are refused before any launch."""
    dev = _cuda()
    y, xh, z, dskip, norm_g, _ = _norm_inputs(2, 64, 8, 64, BF16, dev)
    n0 = _counters()
    with torch.no_grad(), pytest.raises(ValueError, match="does not take"):
        mk.skip_gate_norm(y, xh, z, dskip, norm_g, EPS, 4)
    assert _counters() == n0


@pytest.mark.cuda
def test_cuda_glue_gradients_are_deterministic():
    dev = _cuda()
    b, s, h, p, k = CARD_FORMS[2]
    xi, w, dxh = _conv_inputs(b, s, h, p, k, BF16, dev)
    one, two = mk.conv_silu_heads_bwd(xi, w, dxh), mk.conv_silu_heads_bwd(xi, w, dxh)
    assert all(torch.equal(a, c) for a, c in zip(one, two))
    y, xh, z, dskip, norm_g, dout = _norm_inputs(b, s, h, p, BF16, dev)
    _, rstd = mk.skip_gate_norm(y, xh, z, dskip, norm_g, EPS)
    one = mk.skip_gate_norm_bwd(dout, y, xh, z, dskip, norm_g, rstd)
    two = mk.skip_gate_norm_bwd(dout, y, xh, z, dskip, norm_g, rstd)
    assert all(torch.equal(a, c) for a, c in zip(one, two))


def _stack_grads(cfg, params, batch):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params["layers"]["ssm"].items()}
    params = {**params, "layers": {**params["layers"], "ssm": leaves}}
    loss, _ = T.loss_fn(params, cfg, SINGLE_POD_PLAN, None, batch)
    return [g.clone() for g in torch.autograd.grad(loss, list(leaves.values()))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_mamba_stack_bitwise_with_remat_and_again(dtype):
    dev = _cuda()
    layers = 3
    cfg = dataclasses.replace(get_smoke("mamba2-780m"), n_layers=layers, dtype=dtype)
    params = T.init_params(torch.Generator(dev).manual_seed(0), cfg, SINGLE_POD_PLAN)
    gen = torch.Generator(dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 256), generator=gen, device=dev)
             for k in ("tokens", "labels")}
    n0 = _counters()
    plain = _stack_grads(dataclasses.replace(cfg, remat="none"), params, batch)
    n1 = _counters()
    remat = _stack_grads(dataclasses.replace(cfg, remat="block"), params, batch)
    n2 = _counters()
    again = _stack_grads(dataclasses.replace(cfg, remat="block"), params, batch)
    torch.cuda.synchronize()
    # each kernel once a layer; with remat the forwards twice
    assert n1 == tuple(n + layers for n in n0)
    assert n2 == tuple(n + f * layers for n, f in zip(n1, (2, 1, 2, 1)))
    assert all(torch.equal(a, b) for a, b in zip(plain, remat))
    assert all(torch.equal(a, b) for a, b in zip(remat, again))


def _refused_calls(dev):
    """(name, call) for each form past the kernels' limits, on the card."""
    xi, w, _ = _conv_inputs(2, 64, 4, 16, 4, BF16, dev)
    y, xh, z, dskip, norm_g, _ = _norm_inputs(2, 64, 4, 12, BF16, dev)
    wide = _norm_inputs(1, 16, 80, 64, BF16, dev)[:5]               # di 5,120
    cfg = dataclasses.replace(get_smoke("mamba2-780m"), ssm_conv=5)
    params = T.init_params(torch.Generator(dev).manual_seed(0), cfg, SINGLE_POD_PLAN)
    lp = {k: v[0] for k, v in params["layers"]["ssm"].items()}
    x = torch.randn((2, 64, cfg.d_model), device=dev)
    return [("k5", lambda: mk.conv_silu_heads(xi, torch.zeros(64, 5, device=dev), 4)),
            ("p12", lambda: mk.conv_silu_heads(xi[..., :48].contiguous(), w[:48], 4)),
            ("p12_norm", lambda: mk.skip_gate_norm(y, xh, z, dskip, norm_g, EPS)),
            ("di5120", lambda: mk.skip_gate_norm(*wide, EPS)),
            ("apply_mamba_k5", lambda: PM.apply_mamba(lp, cfg, x))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k5", "p12", "p12_norm", "di5120", "apply_mamba_k5"])
def test_cuda_refuses_forms_the_kernels_do_not_take(case):
    dev = _cuda()
    call = dict(_refused_calls(dev))[case]
    n0 = _counters()
    with torch.no_grad(), pytest.raises(ValueError, match="does not take"):
        call()
    assert _counters() == n0
