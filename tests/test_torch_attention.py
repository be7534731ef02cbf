"""The port's attention (``repro_torch.kernels.flash_attention`` and
``repro_torch.models.attention``) against the JAX package's.

Contract, on the CPU with the plain PyTorch versions, on inputs made with
``np.random.default_rng`` and handed to both packages as NumPy:

- ``blockwise_ref`` (the plain version of the CUDA kernel) against the
  Pallas kernel ``flash_attention_bhsd`` in interpret mode, the oracle
  ``attention_ref`` and the XLA twin ``blockwise_attention``, at
  ``atol = rtol = 3e-5`` in float32 (``tests/test_kernels.py``'s bar):
  GQA 4/1, 8/2 and 4/4, causal and not, a sliding window, S != T, and
  lengths that no block divides; bfloat16 within the reference's 0.05;
- ``rope`` and ``mrope`` at 1e-6 against the reference compiled, as its
  callers run it (XLA folds the constant frequencies and rounds them once;
  the port's frequencies equal those bit for bit);
- ``apply_attention`` (both implementations) and ``decode_attention`` (the
  plain cache, a window, the hybrid ring, and the cache write clamped at
  ``S_max - 1`` as ``dynamic_update_slice`` clamps it) at 1e-5 in float32;
- the kernel's launch plan (pure Python): which path each form of
  ``chip_smoke.FLASH_FORMS`` and each of the 10 configs takes, and that its
  shared memory fits; ``blockwise_ref`` at the ``wgmma`` path's key tile
  (``KEY_TILE``) against the Pallas kernel and the XLA twin; and
  ``chip_smoke.FLASH_TILE == KEY_TILE``;
- the gradient: autograd of the plain version against ``jax.grad`` of the
  reference; the log-sum-exp the forward writes for it (its plain
  counterpart, ``blockwise_ref(..., return_lse=True)``) against
  ``torch.logsumexp`` at 1e-6 of max(1, |lse|); the bfloat16 ``wgmma``
  scheme (P and dS rounded to bfloat16 before the products that take them,
  float32 sums, the forward's lse) emulated in plain PyTorch on
  ``chip_smoke.FLASH_BWD_FORMS``' bfloat16 forms at S <= 1,000, inside
  ``FLASH_BWD_TOL`` against autograd of the plain version and within 2e-2
  of the largest entry of the float32 one; and ``plan_bwd`` for every
  gradient form and config (path, shared memory, blocks covering S).

The CUDA kernels run only on a card: the ``cuda``-marked tests skip here
(``python3 chip_smoke.py`` holds them against the plain versions on the
card, the gradient's 64-seed sweep included).
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
from repro.kernels.flash_attention import kernel as pallas  # noqa: E402
from repro.kernels.flash_attention import ops as ref_ops  # noqa: E402
from repro.kernels.flash_attention import ref as ref_ref  # noqa: E402
from repro.models import attention as RA  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import all_arch_names, get_config, get_smoke  # noqa: E402
from repro_torch.kernels.build import MAX_SMEM_BYTES  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402

TOL = dict(atol=3e-5, rtol=3e-5)


def _qkv(b, hq, hkv, s, t, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


# --------------------------------------------------------------------------
# the plain version of the kernel against the reference's three forms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", [(128, 64), (256, 32), (128, 128)])
def test_blockwise_ref_vs_pallas_interpret(s, d, causal):
    q, k, v = _qkv(3, 1, 1, s, s, d, seed=s + d)
    want = pallas.flash_attention_bhsd(jnp.asarray(q[:, 0]), jnp.asarray(k[:, 0]),
                                       jnp.asarray(v[:, 0]), causal=causal,
                                       block_q=64, block_k=64, interpret=True)
    got = fa.blockwise_ref(_t(q), _t(k), _t(v), causal=causal, block_q=64, block_k=64)
    np.testing.assert_allclose(_np(got)[:, 0], _np(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,t", [(96, 96), (64, 160)])
def test_attention_ref_and_blockwise_ref_vs_oracle(s, t, causal):
    q, k, v = _qkv(2, 4, 4, s, t, 32, seed=s * t)
    bh = lambda a: a.reshape(8, -1, 32)                          # noqa: E731
    want = ref_ref.attention_ref(jnp.asarray(bh(q)), jnp.asarray(bh(k)),
                                 jnp.asarray(bh(v)), causal=causal)
    got = fa.attention_ref(_t(bh(q)), _t(bh(k)), _t(bh(v)), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    blk = fa.blockwise_ref(_t(q), _t(k), _t(v), causal=causal, block_q=32, block_k=48)
    np.testing.assert_allclose(_np(blk).reshape(8, s, 32), _np(want), **TOL)
    rep = fa.attention_reference(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(_np(rep), _np(ref_ops.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)), **TOL)


GQA = [(4, 1), (8, 2), (4, 4)]
CASES = [dict(s=128, t=128, causal=True, window=0),
         dict(s=128, t=128, causal=False, window=0),
         dict(s=128, t=128, causal=True, window=40),
         dict(s=64, t=192, causal=True, window=0),
         dict(s=64, t=192, causal=False, window=50)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("hq,hkv", GQA)
def test_blockwise_vs_reference_blockwise(hq, hkv, case):
    s, t = case["s"], case["t"]
    q, k, v = _qkv(2, hq, hkv, s, t, 32, seed=hq * 10 + hkv + s)
    want = RA.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=case["causal"], window=case["window"],
                                  block_q=32, block_k=64)
    for bq, bk in ((32, 64), (48, 80), (512, 1024)):     # the kernel picks its own tiles
        got = PA.blockwise_attention(_t(q), _t(k), _t(v), causal=case["causal"],
                                     window=case["window"], block_q=bq, block_k=bk)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("s", [100, 257])
def test_blockwise_takes_lengths_no_block_divides(s):
    q, k, v = _qkv(1, 4, 2, s, s, 32, seed=s)
    want = RA.plain_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = PA.blockwise_attention(_t(q), _t(k), _t(v), causal=True, block_q=64, block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_blockwise_bf16_within_reference_bar():
    q, k, v = _qkv(1, 4, 4, 128, 128, 64, seed=4)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)            # noqa: E731
    want = ref_ops.flash_attention(bf(q), bf(k), bf(v), block_q=64, block_k=64)
    tb = lambda a: _t(_np(bf(a)), torch.bfloat16)                 # noqa: E731
    got = PA.blockwise_attention(tb(q), tb(k), tb(v), causal=True)
    assert got.dtype == torch.bfloat16
    assert float(np.abs(_np(got) - _np(want)).max()) < 0.05
    # and the XLA twin, in the same dtype (P rounded to bf16 before PV)
    twin = RA.blockwise_attention(bf(q), bf(k), bf(v), causal=True, block_q=64, block_k=64)
    assert float(np.abs(_np(got) - _np(twin)).max()) < 0.05


# --------------------------------------------------------------------------
# RoPE / M-RoPE
# --------------------------------------------------------------------------

def _ref_rope(theta):
    """The reference's rope as its callers run it: compiled (the engine and
    the trainer jit their steps), so XLA folds the constant frequencies."""
    return jax.jit(lambda q, k, pos: RA.rope(q, k, pos, theta))


def test_rope_matches_reference():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 4, 48, 32)).astype(np.float32)
    k = rng.standard_normal((2, 2, 48, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 48))
    for theta in (1e4, 5e5):
        rq, rk = _ref_rope(theta)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos))
        pq, pk = PA.rope(_t(q), _t(k), torch.from_numpy(pos), theta)
        np.testing.assert_allclose(_np(pq), _np(rq), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(_np(pk), _np(rk), atol=1e-6, rtol=1e-6)
    small = rng.integers(0, 64, (2, 48))
    rq, _ = _ref_rope(1e4)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(small))
    pq, _ = PA.rope(_t(q), _t(k), torch.from_numpy(small), 1e4)
    np.testing.assert_allclose(_np(pq), _np(rq), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("theta,d", [(5e5, 64), (1e4, 128), (1e6, 128), (1e4, 96)])
def test_rope_frequencies_equal_reference_compiled(theta, d):
    """The reference writes ``1 / theta ** (2i / d)`` in float32
    (``models/attention.py`` ``_rope_angles``), but its operands are
    constants, so XLA folds it and rounds once: the port's frequencies are
    those, bit for bit (in float32 the power's rounding moved a third of
    them by an ulp)."""
    want = jax.jit(lambda: 1.0 / (theta ** (jnp.arange(0, d, 2, dtype=jnp.float32) / d)))()
    got = PA._freqs(d, theta, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mrope_matches_reference():
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 4, 40, 32)).astype(np.float32)
    k = rng.standard_normal((2, 2, 40, 32)).astype(np.float32)
    pos3 = rng.integers(0, 64, (2, 3, 40))
    rq, rk = jax.jit(lambda q, k, p: RA.mrope(q, k, p, 1e6, (4, 6, 6)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos3))   # compiled, as _ref_rope
    pq, pk = PA.mrope(_t(q), _t(k), torch.from_numpy(pos3), 1e6, (4, 6, 6))
    np.testing.assert_allclose(_np(pq), _np(rq), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(pk), _np(rk), atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# the layer: apply_attention and decode_attention
# --------------------------------------------------------------------------

def _layer(name, seed=0):
    """(reference cfg, port cfg, reference params, port params) of one smoke
    layer in float32 activations, weights from the shared NumPy seed."""
    rc = dataclasses.replace(ref_smoke(name), dtype="float32")
    pc = dataclasses.replace(get_smoke(name), dtype="float32")
    arrays = {k[len("layers.attn."):]: v[0] for k, v in
              convert.seeded_model_arrays(pc, seed).items() if k.startswith("layers.attn.")}
    rp = {k: jnp.asarray(v.view(jnp.bfloat16)) for k, v in arrays.items()}
    pp = {k: v for k, v in convert.model_params(arrays, "cpu").items()}
    return rc, pc, rp, pp


@pytest.mark.parametrize("impl,window", [("plain", 0), ("blockwise", 0),
                                         ("plain", 24), ("blockwise", 24)])
@pytest.mark.parametrize("name", ["llama3.2-1b", "qwen2-vl-72b"])
def test_apply_attention_matches_reference(name, impl, window):
    rc, pc, rp, pp = _layer(name)
    rng = np.random.default_rng(3)
    b, s = 2, 96
    x = rng.standard_normal((b, s, pc.d_model)).astype(np.float32)
    if pc.mrope:
        pos = rng.integers(0, s, (b, 3, s))
    else:
        pos = np.broadcast_to(np.arange(s)[None], (b, s)).copy()
    r_out, r_k, r_v = RA.apply_attention(rp, rc, jnp.asarray(x), jnp.asarray(pos),
                                         impl=impl, window=window, return_kv=True)
    p_out, p_k, p_v = PA.apply_attention(pp, pc, _t(x), torch.from_numpy(pos),
                                         impl=impl, window=window, return_kv=True)
    for got, want in ((p_out, r_out), (p_k, r_k), (p_v, r_v)):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["plain", "window", "ring", "clamped"])
def test_decode_attention_matches_reference(mode):
    rc, pc, rp, pp = _layer("hymba-1.5b" if mode == "ring" else "llama3.2-1b")
    rng = np.random.default_rng(11)
    b, s_max, hkv, hd = 2, 32, pc.n_kv_heads, pc.hd
    ck = rng.standard_normal((b, hkv, s_max, hd)).astype(np.float32)
    cv = rng.standard_normal((b, hkv, s_max, hd)).astype(np.float32)
    r_ck, r_cv, p_ck, p_cv = jnp.asarray(ck), jnp.asarray(cv), _t(ck), _t(cv)
    kw = {"window": 8} if mode == "window" else {"ring": True} if mode == "ring" else {}
    steps = {"plain": range(0, 6), "window": range(10, 16), "ring": range(28, 40),
             "clamped": range(30, 36)}[mode]
    for t in steps:
        x = rng.standard_normal((b, 1, pc.d_model)).astype(np.float32)
        pos_cache = t % s_max if mode == "ring" else t
        pq = np.full((b, 1), t)
        r_o, r_ck, r_cv = RA.decode_attention(rp, rc, jnp.asarray(x), r_ck, r_cv,
                                              jnp.asarray(pos_cache, jnp.int32),
                                              jnp.asarray(pq), **kw)
        p_o, p_ck, p_cv = PA.decode_attention(pp, pc, _t(x), p_ck, p_cv,
                                              torch.tensor(pos_cache, dtype=torch.int32),
                                              torch.from_numpy(pq), **kw)
        np.testing.assert_allclose(_np(p_o), _np(r_o), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(p_ck), _np(r_ck), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(p_cv), _np(r_cv), atol=1e-5, rtol=1e-5)
    if mode == "clamped":
        # positions 32..35 all landed in the last slot, as in the reference
        assert not np.array_equal(_np(p_ck)[:, :, -1], ck[:, :, -1])
        np.testing.assert_array_equal(_np(p_ck)[:, :, :30], ck[:, :, :30])


# --------------------------------------------------------------------------
# device policy, and the kernel on the card
# --------------------------------------------------------------------------

def test_cpu_takes_the_plain_version_and_kernel_refuses_cpu():
    q, k, v = _qkv(1, 4, 2, 64, 64, 32, seed=1)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=True, window=9)
    want = fa.blockwise_ref(_t(q), _t(k), _t(v), causal=True, window=9)
    assert torch.equal(got, want)
    n0 = fa_kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(_t(q), _t(k), _t(v))
    assert fa_kernel.LAUNCHES == n0


def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports the standard
    library only)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FLASH_FORMS = _chip_smoke().FLASH_FORMS


def _check_plan(dtype, d, s):
    plan = fa_kernel.plan(dtype, d, s)
    wgmma = dtype == torch.bfloat16 and d in (64, 128)
    assert plan["path"] == ("wgmma" if wgmma else "fma")
    assert plan["key_tile"] == (fa_kernel.KEY_TILE if wgmma else 64)
    assert 0 < plan["smem"] <= MAX_SMEM_BYTES
    assert plan["blocks"] * plan["block_q"] >= s > (plan["blocks"] - 1) * plan["block_q"]
    if wgmma:           # a producer warpgroup and 64 query rows per consumer
        assert plan["threads"] == 128 * (1 + plan["block_q"] // 64)
        assert plan["stages"] >= 2
    return plan


@pytest.mark.parametrize("form", FLASH_FORMS, ids=lambda f: f[0])
def test_launch_plan_of_chip_smoke_forms(form):
    _, _, b, hq, hkv, s, d, window, dt = form
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    plan = _check_plan(dtype, d, s)
    assert plan["path"] == ("wgmma" if dt == "bf16" and d != 32 else "fma")


@pytest.mark.parametrize("name", all_arch_names())
def test_launch_plan_of_configs(name):
    """Every config's attention (bfloat16, its head dim) takes the wgmma
    path at full width and the FMA path at smoke width (D 32)."""
    for cfg, path in ((get_config(name), "wgmma"), (get_smoke(name), "fma")):
        assert cfg.dtype == "bfloat16"
        assert _check_plan(torch.bfloat16, cfg.hd, 8192)["path"] == path


def test_chip_smoke_flash_tile_is_the_kernel_key_tile():
    assert _chip_smoke().FLASH_TILE == fa_kernel.KEY_TILE


@pytest.mark.parametrize("s,t,window", [(256, 256, 0), (256, 256, 64), (128, 384, 0)])
def test_blockwise_ref_at_key_tile_vs_pallas_and_twin(s, t, window):
    """The plain version at the kernel's key tile against the Pallas kernel
    (interpret mode, where S == T and no window) and the XLA twin (which
    takes lengths its blocks divide)."""
    tile = fa_kernel.KEY_TILE
    q, k, v = _qkv(1, 4, 2, s, t, 64, seed=s + window)
    twin = RA.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=True, window=window, block_q=64, block_k=tile)
    got = fa.blockwise_ref(_t(q), _t(k), _t(v), causal=True, window=window, block_k=tile)
    np.testing.assert_allclose(_np(got), _np(twin), **TOL)
    if s == t and not window:
        rk, rv = (np.repeat(a, 2, axis=1) for a in (k, v))
        pal = pallas.flash_attention_bhsd(jnp.asarray(q[0]), jnp.asarray(rk[0]),
                                          jnp.asarray(rv[0]), causal=True, block_q=64,
                                          block_k=tile, interpret=True)
        np.testing.assert_allclose(_np(got)[0], _np(pal), **TOL)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)            # noqa: E731
    tb = lambda a: _t(_np(bf(a)), torch.bfloat16)                 # noqa: E731
    got16 = fa.blockwise_ref(tb(q), tb(k), tb(v), causal=True, window=window,
                             block_k=tile)
    twin16 = RA.blockwise_attention(bf(q), bf(k), bf(v), causal=True, window=window,
                                    block_q=64, block_k=tile)
    assert got16.dtype == torch.bfloat16
    assert float(np.abs(_np(got16) - _np(twin16)).max()) < 0.05
    if s == t and not window:
        pal16 = pallas.flash_attention_bhsd(bf(q[0]), bf(rk[0]), bf(rv[0]), causal=True,
                                            block_q=64, block_k=tile, interpret=True)
        assert float(np.abs(_np(got16)[0] - _np(pal16)).max()) < 0.05


@pytest.mark.parametrize("form", _chip_smoke().FLASH_CROSS_FORMS)
def test_launch_plan_of_chip_smoke_cross_forms(form):
    """chip_smoke.py's T > S forms have more query rows than the FMA head,
    so they reach the wgmma kernel with the rows' offset T - S."""
    _, _, _, s, t, d = form
    plan = _check_plan(torch.bfloat16, d, s)
    assert plan["path"] == "wgmma" and t > s > plan["fma_rows"] == plan["block_q"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_kernel_vs_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    dev = torch.device("cuda")
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    for (s, t, window) in ((256, 256, 0), (200, 200, 64), (100, 300, 0), (300, 500, 0)):
        for d in ((64,) if dtype == "f32" else (64, 128)):
            q, k, v = (_t(a, dt).to(dev) for a in _qkv(2, 8, 2, s, t, d, seed=s))
            n0, w0 = fa_kernel.LAUNCHES, fa_kernel.LAUNCHES_WGMMA
            got = fa_kernel.flash_attention(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            assert fa_kernel.LAUNCHES == n0 + 1
            # the first wgmma block's rows run on the FMA pipes: a call with
            # no more rows than that (S 100) launches no wgmma kernel; one
            # with more launches it from that row on, with T > S at S 300
            plan = fa_kernel.plan(dt, d, s)
            wgmma = dtype == "bf16" and s > plan["block_q"]
            assert plan["path"] == ("wgmma" if wgmma else "fma")
            assert fa_kernel.LAUNCHES_WGMMA == w0 + wgmma
            if dtype == "f32":
                want = fa.blockwise_ref(q, k, v, causal=True, window=window)
                torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)
            else:
                # the plain version in bfloat16 at the kernel's key tiles
                # rounds P as the kernel does: within an output ulp plus 1e-3
                want = fa.blockwise_ref(q, k, v, causal=True, window=window,
                                        block_k=fa_kernel.KEY_TILE)
                torch.testing.assert_close(got.float(), want.float(), atol=1e-3,
                                           rtol=2 ** -7)
                ref32 = fa.blockwise_ref(q.float(), k.float(), v.float(), causal=True,
                                         window=window)
                assert float((got.float() - ref32).abs().max()) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("form", _chip_smoke().FLASH_SEED_FORMS)
def test_cuda_bf16_bar_over_seeds(form):
    """The bfloat16 kernel against the plain version at its key tiles over
    chip_smoke.py's seeds 0-31, each inside the bar (atol 1e-3, rtol 2**-7),
    every (form, seed) but those in FLASH_SEED_FAULTS (none since the
    kernel's first block of rows runs on the FMA pipes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    _, _, b, hq, hkv, s, d, window, _ = next(f for f in FLASH_FORMS if f[1] == form)
    for seed in cs.FLASH_SEEDS:
        if (form, seed) in cs.FLASH_SEED_FAULTS:
            continue
        q, k, v = cs._attn_inputs(b, hq, hkv, s, d, dev, torch.bfloat16, seed)
        got = fa_kernel.flash_attention(q, k, v, causal=True, window=window)
        want = fa.blockwise_ref(q, k, v, causal=True, window=window,
                                block_k=fa_kernel.KEY_TILE)
        share = cs.flash_bar_share(got.float(), want.float())
        assert share["bar_share"] <= 1.0, (form, seed, share)


# --------------------------------------------------------------------------
# gradients
# --------------------------------------------------------------------------

GRAD_CASES = [dict(s=128, hq=8, hkv=2, window=0, d=32),
              dict(s=128, hq=8, hkv=2, window=40, d=32),
              dict(s=100, hq=4, hkv=1, window=0, d=64),
              dict(s=96, hq=4, hkv=4, window=17, d=32)]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_attention_grads_vs_reference(case):
    """dq, dk, dv of the port's attention on the CPU (autograd of the plain
    version, which the card's gradient kernel is held to) against jax.grad
    of the reference's blockwise_attention and plain_attention: GQA, a
    sliding window, a length no block divides, at atol 1e-5 of the largest
    entry and rtol 1e-4 in float32."""
    s, d = case["s"], case["d"]
    q, k, v = _qkv(2, case["hq"], case["hkv"], s, s, d, seed=s + case["window"])
    do = np.random.default_rng(s).standard_normal(q.shape).astype(np.float32)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    o = fa.flash_attention(*leaves, causal=True, window=case["window"],
                           block_q=32, block_k=48)
    got = torch.autograd.grad(o, leaves, _t(do))
    # the reference's blockwise tiles must divide S (25 and 50 at S 100)
    bq, bk = (32, 64) if s % 64 == 0 else (s // 4, s // 2)
    for fn in (lambda *t: RA.blockwise_attention(*t, causal=True, window=case["window"],
                                                 block_q=bq, block_k=bk),
               lambda *t: RA.plain_attention(*t, causal=True, window=case["window"])):
        want = jax.grad(lambda *t: jnp.sum(fn(*t) * do), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            w = _np(w)
            np.testing.assert_allclose(_np(g), w, atol=1e-5 * float(np.abs(w).max()),
                                       rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("form", _chip_smoke().FLASH_BWD_FORMS, ids=lambda f: f"{f[0]}-{f[1]}")
def test_chip_smoke_bwd_forms_are_accepted(form):
    """chip_smoke.py's gradient forms: the shapes the gradient kernel takes
    (S = T, a head dim it has, GQA)."""
    _, _, b, hq, hkv, s, d, window, dt = form
    assert d in fa_kernel.HEAD_DIMS and hq % hkv == 0 and dt in ("f32", "bf16")
    assert window == 0 or window < s


def test_bwd_kernel_refuses_cpu_and_s_not_t():
    q, k, v = (_t(a) for a in _qkv(1, 4, 2, 64, 64, 32, seed=3))
    n0 = fa_kernel.BWD_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_bwd(q, k, v, q, q)
    with pytest.raises(RuntimeError, match="requires a gradient"):
        fa_kernel.flash_attention(q.requires_grad_(True), k, v)
    assert fa_kernel.BWD_LAUNCHES == n0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_bwd_kernel_vs_plain(dtype):
    """FlashAttentionFn on the card (its backward: the gradient kernel)
    against autograd of the plain version, at chip_smoke.py's bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    for s, window, d in ((256, 0, 64), (200, 64, 128), (130, 0, 32)):
        q, k, v = (_t(a, dt).to(dev) for a in _qkv(2, 8, 2, s, s, d, seed=s))
        do = torch.randn(q.shape, device=dev).to(dt)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        n0 = fa_kernel.BWD_LAUNCHES
        o = fa.flash_attention(*leaves, causal=True, window=window)
        got = torch.autograd.grad(o, leaves, do)
        assert fa_kernel.BWD_LAUNCHES == n0 + 1
        want = cs._attn_plain_grads(q, k, v, do, window,
                                    fa_kernel.KEY_TILE if dtype == "bf16" else 1024)
        assert cs._grad_share(got, want, *cs.FLASH_BWD_TOL[dtype]) <= 1.0, (dtype, s)


# --------------------------------------------------------------------------
# the gradient's wgmma scheme, its log-sum-exp input and its launch plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,d,window,hq,hkv,block_k", [
    (200, 64, 0, 4, 2, 128), (300, 128, 64, 8, 2, 128), (130, 32, 0, 4, 1, 64),
    (257, 64, 100, 4, 4, 1024)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_forward_lse_is_the_logsumexp(s, d, window, hq, hkv, block_k, dt):
    """The log-sum-exp the forward writes for the gradient (the plain
    counterpart, m + ln l of the online softmax) equals torch.logsumexp of
    the masked scaled scores within 1e-6 of max(1, |lse|), and the output
    is the same with or without it."""
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    q, k, v = (_t(a, dtype) for a in _qkv(1, hq, hkv, s, s, d, seed=s + d))
    o, lse = fa.blockwise_ref(q, k, v, causal=True, window=window, block_k=block_k,
                              return_lse=True)
    assert torch.equal(o, fa.blockwise_ref(q, k, v, causal=True, window=window,
                                           block_k=block_k))
    kr = k.float().repeat_interleave(hq // hkv, dim=1)
    sc = torch.einsum("bhsd,bhtd->bhst", q.float(), kr) * (1.0 / d ** 0.5)
    i, j = torch.arange(s)[:, None], torch.arange(s)[None, :]
    masked = (i < j) | ((i - j >= window) if window else torch.zeros_like(i < j))
    want = torch.logsumexp(sc.masked_fill(masked, -1e30), dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == (1, hq, s)
    assert float(((lse - want).abs() / want.abs().clamp_min(1.0)).max()) <= 1e-6


def _emulate_wgmma_grad(q, k, v, do, window):
    """The bfloat16 gradient as the wgmma passes compute it, in plain
    PyTorch: the forward's lse (m and l of the online softmax at
    ``KEY_TILE``), D = do.o from the bfloat16 forward output, P =
    2^(s c - lse log2 e) and dS = P (dP - D) in float32, P and dS rounded
    to bfloat16 before dV = P^T.dO, dK = dS^T.Q and dQ = dS.K (float32
    sums), each output rounded to bfloat16 once.  One KV head's group at a
    time."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    rep = hq // hkv
    o, lse = fa.blockwise_ref(q, k, v, causal=True, window=window,
                              block_k=fa_kernel.KEY_TILE, return_lse=True)
    scale = 1.0 / d ** 0.5
    c = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    lse2 = lse * torch.tensor(1.4426950408889634, dtype=torch.float32)
    delta = (do.float() * o.float()).sum(-1)
    i, j = torch.arange(s)[:, None], torch.arange(s)[None, :]
    visible = (j <= i) & ((i - j < window) if window else torch.ones_like(j <= i))
    dq, dk, dv = (torch.empty(x.shape, dtype=torch.float32) for x in (q, k, v))
    bf = lambda x: x.to(torch.bfloat16).float()                   # noqa: E731
    for g in range(hkv):
        hs = slice(g * rep, (g + 1) * rep)
        qg, dog = q[:, hs].float(), do[:, hs].float()
        kg, vg = k[:, g:g + 1].float(), v[:, g:g + 1].float()
        sc = torch.einsum("bhsd,bhtd->bhst", qg, kg.expand(-1, rep, -1, -1))
        p = torch.exp2(sc * c - lse2[:, hs, :, None]).masked_fill(~visible, 0.0)
        dp = torch.einsum("bhsd,bhtd->bhst", dog, vg.expand(-1, rep, -1, -1))
        ds = p * (dp - delta[:, hs, :, None])
        dv[:, g] = torch.einsum("bhst,bhsd->btd", bf(p), dog)
        dk[:, g] = torch.einsum("bhst,bhsd->btd", bf(ds), qg) * scale
        dq[:, hs] = torch.einsum("bhst,bhtd->bhsd", bf(ds),
                                 kg.expand(-1, rep, -1, -1)) * scale
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


_BF16_BWD_FORMS = [f for f in _chip_smoke().FLASH_BWD_FORMS if f[8] == "bf16"]


@pytest.mark.parametrize("form", _BF16_BWD_FORMS, ids=lambda f: f"{f[0]}-{f[1]}")
def test_wgmma_grad_scheme_within_the_bars(form):
    """The bfloat16 wgmma gradient's precision scheme, emulated on the CPU
    on chip_smoke.py's bfloat16 gradient forms (S cut to 1,000 where it is
    longer, heads, head dim and window kept): inside FLASH_BWD_TOL against
    autograd of the plain version in bfloat16 at KEY_TILE, and within 2e-2
    of the largest entry of the plain version in float32."""
    cs = _chip_smoke()
    _, _, b, hq, hkv, s, d, window, _ = form
    s = min(s, 1000)
    rng = np.random.default_rng(s + hq + d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   .to(torch.bfloat16)
                   for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d)))
    got = _emulate_wgmma_grad(q, k, v, do, window)
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)
    want = cs._attn_plain_grads(q, k, v, do, window, fa_kernel.KEY_TILE)
    assert cs._grad_share(got, want, *cs.FLASH_BWD_TOL["bf16"]) <= 1.0
    f32 = cs._attn_plain_grads(q.float(), k.float(), v.float(), do.float(), window, 1024)
    assert cs._grad_share(got, f32, 2e-2, 0.0) <= 1.0


def _check_plan_bwd(dtype, d, s):
    plan = fa_kernel.plan_bwd(dtype, d, s)
    wgmma = dtype == torch.bfloat16 and d in (64, 128)
    assert plan["path"] == ("wgmma" if wgmma else "fma")
    assert 0 < plan["smem_kv"] <= MAX_SMEM_BYTES and 0 < plan["smem_q"] <= MAX_SMEM_BYTES
    # the blocks of each pass cover every key (dK/dV) and query row (dQ)
    for n in (plan["kv_blocks"], plan["q_blocks"]):
        assert n * plan["block"] >= s > (n - 1) * plan["block"]
    assert plan["block"] % plan["tile"] == 0
    # lse2 and D rows padded to a multiple of every tile and block
    assert plan["pitch"] >= s and plan["pitch"] % plan["block"] == 0
    assert plan["smem"] == max(plan["smem_kv"], plan["smem_q"])
    if wgmma:           # a producer warpgroup and two consumers of 64 rows
        assert plan["threads"] == 384 and plan["block"] == 128 and plan["stages"] >= 2
    return plan


@pytest.mark.parametrize("form", _chip_smoke().FLASH_BWD_FORMS, ids=lambda f: f"{f[0]}-{f[1]}")
def test_plan_bwd_of_chip_smoke_forms(form):
    _, _, b, hq, hkv, s, d, window, dt = form
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    _check_plan_bwd(dtype, d, s)


@pytest.mark.parametrize("name", all_arch_names())
def test_plan_bwd_of_configs(name):
    """Every config's attention gradient (bfloat16, its head dim) takes the
    wgmma passes at full width and the FMA passes at smoke width (D 32), at
    its training length and a ragged one."""
    for cfg, path in ((get_config(name), "wgmma"), (get_smoke(name), "fma")):
        for s in (8192, 1000):
            assert _check_plan_bwd(torch.bfloat16, cfg.hd, s)["path"] == path


@pytest.mark.cuda
@pytest.mark.parametrize("form", _chip_smoke().FLASH_BWD_SEED_FORMS, ids=lambda f: f[0])
def test_cuda_bf16_bwd_bar_over_seeds(form):
    """The bfloat16 gradient (the wgmma passes) against autograd of the
    plain version at KEY_TILE over chip_smoke.py's 64 seeds, each (inputs,
    incoming gradient) pair inside FLASH_BWD_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    cs = _chip_smoke()
    dev = torch.device("cuda")
    for seed in cs.FLASH_BWD_SEEDS:
        share = cs.flash_bwd_seed_share(form, seed, dev)
        assert share["bar_share"] <= 1.0 and share["wgmma"], (form[0], seed, share)
