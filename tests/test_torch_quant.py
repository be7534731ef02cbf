"""The port's int8 payload quantization (``repro_torch.kernels.quant_pack``)
against the JAX package's Pallas kernels.

Contract, on the CPU with the plain PyTorch versions: ``quantize_ref`` and
``dequantize_ref`` are bitwise equal to ``kernels/quant_pack/kernel.py``
``quantize``/``dequantize`` run in interpret mode (the compiled form of the
scale, ``max(absmax, 1e-30) * float32(1/127)``), for float32 and bfloat16
inputs, with all-zero groups, exact ``.5`` ties (a group whose absmax is 127
has scale 1.0) and rows whose scales span 0.01 to 100; ``compress``/
``decompress`` round-trip like the reference's ops with the Pallas path, and
``compression_ratio`` agrees.  Inputs come from ``np.random.default_rng``
and go to both packages as NumPy.  The CUDA kernels run only on a card: the
``cuda``-marked test skips here (``python3 chip_smoke.py`` holds them to
the plain versions on the card).
"""

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

from repro.kernels.quant_pack import kernel as pallas  # noqa: E402
from repro.kernels.quant_pack import ops as ref_ops  # noqa: E402

from repro_torch.kernels import quant_pack  # noqa: E402
from repro_torch.kernels.quant_pack import kernel as port_kernel  # noqa: E402
from repro_torch.kernels.quant_pack.ref import (dequantize_ref,  # noqa: E402
                                                quantize_ref)

SHAPES = [(8, 128), (64, 512), (256, 256)]


def _inputs(shape, seed):
    """Rows scaled from 0.01 to 100, an all-zero group, a group of exact
    .5 ties (absmax 127 -> scale 1.0) and a group of one spike."""
    r, c = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((r, c)) * np.exp(rng.uniform(np.log(0.01),
                                                         np.log(100), (r, 1)))
    x[0, :128] = 0.0
    ties = rng.integers(-126, 126, 128) + 0.5
    ties[0] = 127.0
    x[1 % r, :128] = ties
    x[2 % r, :128] = 0.0
    x[2 % r, 5] = -3.0e-3
    return x.astype(np.float32)


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _to_torch(x, dtype):
    t = torch.from_numpy(np.array(x))
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _np(a):
    """JAX or torch array -> NumPy, bfloat16 as float32 (exact)."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_bitwise_vs_pallas(shape, dtype):
    x = _inputs(shape, seed=shape[0])
    q_ref, s_ref = pallas.quantize(_to_jax(x, dtype), interpret=True)
    q, s = quantize_ref(_to_torch(x, dtype))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    # the tie group rounded half to even, the zero groups gave code 0
    assert s[1 % shape[0], 0] == 1.0
    assert (q[0, :128] == 0).all()


@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_dequantize_bitwise_vs_pallas(shape, out_dtype):
    rng = np.random.default_rng(7)
    r, c = shape
    q = rng.integers(-127, 128, (r, c)).astype(np.int8)
    s = (rng.uniform(0.01, 100, (r, c // 128)) / 127).astype(np.float32)
    s[0, 0] = np.float32(1e-30) * np.float32(1 / 127)       # an all-zero group
    jdt = jnp.bfloat16 if out_dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if out_dtype == "bf16" else torch.float32
    want = pallas.dequantize(jnp.asarray(q), jnp.asarray(s), out_dtype=jdt,
                             interpret=True)
    got = dequantize_ref(torch.from_numpy(q), torch.from_numpy(s), tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_then_dequantize_round_trip(dtype):
    x = _inputs((64, 512), seed=3)
    q, s = quant_pack.quantize(_to_torch(x, dtype))
    back = quant_pack.dequantize(q, s, torch.float32).numpy()
    src = _np(_to_torch(x, dtype))
    # |error| is at most half a step of the group's scale, plus the float32
    # rounding of q * s (under 127 ulps of 2**-23 of a step)
    step = np.repeat(s.numpy(), 128, axis=1)
    assert (np.abs(back - src) <= (0.5 + 2e-5) * step).all()


@pytest.mark.parametrize("shape,dtype", [((3, 5, 7), "f32"), ((2, 300), "bf16"),
                                         ((4, 64, 128), "bf16")])
def test_compress_decompress_equal_the_reference(shape, dtype):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(shape) * 5).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q_ref, s_ref, meta_ref = ref_ops.compress(_to_jax(x, dtype), use_pallas=True)
    q, s, meta = quant_pack.compress(_to_torch(x, dtype))
    assert meta == meta_ref
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    want = ref_ops.decompress(q_ref, s_ref, meta_ref, dtype=jdt, use_pallas=True)
    got = quant_pack.decompress(q, s, meta, dtype=tdt)
    assert tuple(got.shape) == shape and got.dtype == tdt
    np.testing.assert_array_equal(_np(got), _np(want))
    assert quant_pack.compression_ratio(_to_torch(x, dtype)) == pytest.approx(
        ref_ops.compression_ratio(_to_jax(x, dtype)), rel=1e-12)


def test_cpu_tensors_take_the_plain_version_and_kernels_refuse_them():
    x = torch.from_numpy(_inputs((8, 256), seed=1))
    n_q, n_d = port_kernel.QUANTIZE_LAUNCHES, port_kernel.DEQUANTIZE_LAUNCHES
    q, s = quant_pack.quantize(x)
    quant_pack.dequantize(q, s, torch.bfloat16)
    assert (port_kernel.QUANTIZE_LAUNCHES, port_kernel.DEQUANTIZE_LAUNCHES) == (n_q, n_d)
    with pytest.raises(ValueError, match="CUDA"):
        port_kernel.quantize(x)
    with pytest.raises(ValueError, match="CUDA"):
        port_kernel.dequantize(q, s)


# --------------------------------------------------------------------------
# on the card only
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_kernels_bitwise_vs_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    dev = torch.device("cuda")
    x = _to_torch(_inputs((256, 1024), seed=5), dtype).to(dev)
    q, s = port_kernel.quantize(x)
    q_ref, s_ref = quantize_ref(x)
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    for out in (torch.float32, torch.bfloat16):
        assert torch.equal(port_kernel.dequantize(q, s, out),
                           dequantize_ref(q, s, out))
