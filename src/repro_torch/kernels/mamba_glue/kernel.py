"""Binding of the Mamba-2 mixer's fused glue (``csrc/mamba_glue.cu``).

Replaces no Pallas kernel: the JAX package leaves the mixer's elementwise
glue to XLA (``models/mamba2.py`` ``apply_mamba``), and the port's plain code
runs it as full-size PyTorch passes.  Two functions, each with its gradient,
on either side of the SSD scan; all four are bound by bytes (the note at the
top of the CUDA source):

- ``conv_silu_heads(xi, w, heads, bias=None)``: xi [B, S, di] (bfloat16 or
  float32), the conv's taps w [di, K] float32 (K <= 4) and, where the mixer
  has one, its bias [di] float32 give xh [B·H, S, P] in xi's dtype, H =
  ``heads``, P = di / H a multiple of 8: ``ref.causal_conv`` plus the bias,
  SiLU in float32 and one rounding, written in the SSD scan's layout (one
  launch, ``mamba_conv_silu_fwd``).  ``conv_silu_heads_bwd(xi, w, dxh,
  bias=None)`` gives (dxi in xi's dtype, dw float32, and dbias float32 with
  a bias): ``mamba_conv_silu_bwd`` and the partials' sum.
- ``skip_gate_norm(y, xh, z, dskip, norm_g, eps, groups=1)``: y, xh [B·H, S,
  P] and z [B, S, di] of one dtype, dskip [H] and norm_g [di] float32 give
  (out [B, S, di] in that dtype, rstd [B·S·groups] float32):
  ``(y + xh·D)·silu(z)``, RMS over each of ``groups`` equal groups of di,
  ``norm_g``, one rounding (``mamba_gate_norm_fwd``); more than one group
  needs di / groups a multiple of 256 (whole warps of the kernel's threads).
  ``skip_gate_norm_bwd(dout, y, xh, z, dskip, norm_g, rstd, groups=1)``
  gives (dy, dxh's skip term, dz in that dtype, ddskip [H], dnorm_g [di]
  float32): ``mamba_gate_norm_bwd`` and two sums of partials.

Every tensor contiguous on one CUDA device, the activations and norm_g on
16-byte boundaries (vector loads), checked here.  The limits of the tiling
(P a multiple of 8, K <= 4, di <= 4,096) live in the CUDA source alone: a
launcher refuses a form past them before launching anything, and the
wrapper raises ``ValueError``.  The sums over rows are per-block partials
(scratch sized by the library) added in a fixed order
(``mamba_glue_colsum``): two calls on the same inputs give the same bits.
``ref.py`` states both functions and both gradients in plain PyTorch.

One counter a kernel, each raised beside its launch: ``CONV_LAUNCHES``
(``mamba_conv_silu_fwd``), ``CONV_BWD_LAUNCHES``, ``NORM_LAUNCHES``
(``mamba_gate_norm_fwd``), ``NORM_BWD_LAUNCHES``; and one a form that the
kernels take beside their first: ``CONV_BIAS_LAUNCHES`` and
``CONV_BIAS_BWD_LAUNCHES`` (the conv with a bias), ``NORM_GROUPED_LAUNCHES``
and ``NORM_GROUPED_BWD_LAUNCHES`` (the gate norm over groups), each raised
with its kernel's own.  The bindings raise when
grad mode is on and an input requires a gradient: ``ops.ConvSiluHeadsFn``
and ``ops.SkipGateNormFn`` are the differentiable ops.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import check_launch, check_no_grad, library

__all__ = ["CONV_LAUNCHES", "CONV_BWD_LAUNCHES", "NORM_LAUNCHES", "NORM_BWD_LAUNCHES",
           "CONV_BIAS_LAUNCHES", "CONV_BIAS_BWD_LAUNCHES", "NORM_GROUPED_LAUNCHES",
           "NORM_GROUPED_BWD_LAUNCHES", "conv_silu_heads", "conv_silu_heads_bwd",
           "skip_gate_norm", "skip_gate_norm_bwd"]

#: launches of each kernel since the counters were last reset
CONV_LAUNCHES = 0
CONV_BWD_LAUNCHES = 0
NORM_LAUNCHES = 0
NORM_BWD_LAUNCHES = 0
#: of them, the launches of the conv with a bias and of the grouped gate norm
CONV_BIAS_LAUNCHES = 0
CONV_BIAS_BWD_LAUNCHES = 0
NORM_GROUPED_LAUNCHES = 0
NORM_GROUPED_BWD_LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: what a launcher returns for a form the kernels do not take
_REFUSED = -1


def _lib():
    lib = library("mamba_glue")
    if not getattr(lib, "_spac_typed", False):
        for sfx in _DTYPES.values():
            getattr(lib, "mamba_conv_silu_fwd_" + sfx).argtypes = [_P] * 4 + [_I] * 5 + [_P]
            getattr(lib, "mamba_conv_silu_bwd_" + sfx).argtypes = [_P] * 7 + [_I] * 5 + [_P]
            getattr(lib, "mamba_gate_norm_fwd_" + sfx).argtypes = (
                [_P] * 7 + [_I] * 5 + [ctypes.c_float, _P])
            getattr(lib, "mamba_gate_norm_bwd_" + sfx).argtypes = [_P] * 13 + [_I] * 5 + [_P]
            for kind in ("conv_silu_fwd", "conv_silu_bwd", "gate_norm_fwd", "gate_norm_bwd"):
                getattr(lib, f"mamba_{kind}_{sfx}").restype = ctypes.c_int
        lib.mamba_conv_silu_bwd_scratch.argtypes = [_I] * 4
        lib.mamba_gate_norm_bwd_scratch.argtypes = [_I] * 3
        for fn in (lib.mamba_conv_silu_bwd_scratch, lib.mamba_gate_norm_bwd_scratch):
            fn.restype = ctypes.c_longlong
        lib._spac_typed = True
    return lib


def _launched(code: int, what: str, **form: int) -> None:
    """Raise ``ValueError`` if the launcher refused the form (nothing ran),
    ``KernelError`` on a CUDA error."""
    if code == _REFUSED:
        raise ValueError(f"{what} does not take {form}: see the form checks of "
                         "csrc/mamba_glue.cu (P a multiple of 8, 1 to 4 taps, di up to 4,096, "
                         "groups of a multiple of 256 channels)")
    check_launch(code, what)


def _check(t: torch.Tensor, name: str, dtype, shape, *, aligned: bool = True) -> None:
    """Raise unless ``t`` has ``dtype`` and ``shape``, is contiguous and, if
    ``aligned``, starts on a 16-byte boundary."""
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (vector loads)")


def _on_cuda(**tensors: torch.Tensor) -> None:
    """Raise unless every tensor is on one CUDA device (checked after the
    forms, so that the CPU tests reach every other refusal)."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} is on {t.device}: the mixer's glue kernels take "
                             "tensors on one CUDA device (the plain version is ref.py)")


def _act_dtype(t: torch.Tensor, name: str):
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernels take float32 or bfloat16")
    return t.dtype


def _conv_form(xi, w, heads, bias):
    if xi.dim() != 3 or w.dim() != 2:
        raise ValueError("xi must be [B, S, di] and w [di, K]")
    b, s, di = xi.shape
    if heads < 1 or di % heads:
        raise ValueError(f"di={di} does not split into {heads} heads")
    dt = _act_dtype(xi, "xi")
    _check(xi, "xi", dt, (b, s, di))
    _check(w, "w", torch.float32, (di, w.shape[1]), aligned=False)
    if bias is not None:
        _check(bias, "bias", torch.float32, (di,), aligned=False)
    return b, s, di, di // heads, w.shape[1]


def _ptr(t) -> int:
    """A tensor's address, or null for an absent one."""
    return None if t is None else t.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def conv_silu_heads(xi: torch.Tensor, w: torch.Tensor, heads: int,
                    bias=None) -> torch.Tensor:
    """Launch ``mamba_conv_silu_fwd``: xh [B·H, S, P] in xi's dtype."""
    global CONV_LAUNCHES, CONV_BIAS_LAUNCHES
    check_no_grad("conv_silu_heads", *(t for t in (xi, w, bias) if t is not None))
    b, s, di, p, k = _conv_form(xi, w, heads, bias)
    _on_cuda(xi=xi, w=w, **({} if bias is None else {"bias": bias}))
    xh = torch.empty((b * heads, s, p), dtype=xi.dtype, device=xi.device)
    if xh.numel():
        fn = getattr(_lib(), "mamba_conv_silu_fwd_" + _DTYPES[xi.dtype])
        with torch.cuda.device(xi.device):
            code = fn(xi.data_ptr(), w.data_ptr(), _ptr(bias), xh.data_ptr(), b, s, di, p, k,
                      _stream(xi.device))
        _launched(code, "mamba_conv_silu_fwd", B=b, S=s, di=di, P=p, K=k)
        CONV_LAUNCHES += 1
        CONV_BIAS_LAUNCHES += bias is not None
    return xh


def conv_silu_heads_bwd(xi: torch.Tensor, w: torch.Tensor, dxh: torch.Tensor, bias=None):
    """Launch ``mamba_conv_silu_bwd`` and the sum of its partials: (dxi in
    xi's dtype, dw [di, K] float32), and with a ``bias`` dbias [di] float32
    third, for the incoming gradient ``dxh``."""
    global CONV_BWD_LAUNCHES, CONV_BIAS_BWD_LAUNCHES
    check_no_grad("conv_silu_heads_bwd", *(t for t in (xi, w, dxh, bias) if t is not None))
    if dxh.dim() != 3 or xi.dim() != 3 or xi.shape[0] == 0 or dxh.shape[0] % xi.shape[0]:
        raise ValueError("dxh must be [B·H, S, P] for xi [B, S, di]")
    heads = dxh.shape[0] // xi.shape[0]
    b, s, di, p, k = _conv_form(xi, w, heads, bias)
    _check(dxh, "dxh", xi.dtype, (b * heads, s, p))
    _on_cuda(xi=xi, w=w, dxh=dxh, **({} if bias is None else {"bias": bias}))
    ks = k + (bias is not None)                      # dw's columns, dbias the last
    dxi = torch.empty_like(xi)
    dwb = torch.zeros((di, ks), dtype=torch.float32, device=xi.device)
    if xi.numel():
        lib = _lib()
        part = torch.empty(lib.mamba_conv_silu_bwd_scratch(b, s, di, ks), dtype=torch.float32,
                           device=xi.device)
        fn = getattr(lib, "mamba_conv_silu_bwd_" + _DTYPES[xi.dtype])
        with torch.cuda.device(xi.device):
            code = fn(xi.data_ptr(), w.data_ptr(), _ptr(bias), dxh.data_ptr(), dxi.data_ptr(),
                      dwb.data_ptr(), part.data_ptr(), b, s, di, p, k, _stream(xi.device))
        _launched(code, "mamba_conv_silu_bwd", B=b, S=s, di=di, P=p, K=k)
        CONV_BWD_LAUNCHES += 1
        CONV_BIAS_BWD_LAUNCHES += bias is not None
    if bias is None:
        return dxi, dwb
    return dxi, dwb[:, :k].contiguous(), dwb[:, k].contiguous()


def _norm_form(y, xh, z, dskip, norm_g, groups):
    if z.dim() != 3 or y.dim() != 3:
        raise ValueError("y and xh must be [B·H, S, P] and z [B, S, di]")
    b, s, di = z.shape
    if b == 0 or y.shape[0] % b:
        raise ValueError(f"y has {y.shape[0]} rows of heads for {b} sequences")
    heads = y.shape[0] // b
    p = y.shape[-1]
    if heads * p != di:
        raise ValueError(f"{heads} heads of P={p} for di={di}")
    if groups < 1 or di % groups:
        raise ValueError(f"di={di} does not split into {groups} groups")
    dt = _act_dtype(z, "z")
    for name, t in (("y", y), ("xh", xh)):
        _check(t, name, dt, (b * heads, s, p))
    _check(z, "z", dt, (b, s, di))
    _check(dskip, "dskip", torch.float32, (heads,), aligned=False)
    _check(norm_g, "norm_g", torch.float32, (di,))
    return b, s, di, p


def skip_gate_norm(y, xh, z, dskip, norm_g, eps: float, groups: int = 1):
    """Launch ``mamba_gate_norm_fwd``: (out [B, S, di] in z's dtype, rstd
    [B·S·groups] float32)."""
    global NORM_LAUNCHES, NORM_GROUPED_LAUNCHES
    check_no_grad("skip_gate_norm", y, xh, z, dskip, norm_g)
    b, s, di, p = _norm_form(y, xh, z, dskip, norm_g, groups)
    _on_cuda(y=y, xh=xh, z=z, dskip=dskip, norm_g=norm_g)
    out = torch.empty_like(z)
    rstd = torch.empty(b * s * groups, dtype=torch.float32, device=z.device)
    if out.numel():
        fn = getattr(_lib(), "mamba_gate_norm_fwd_" + _DTYPES[z.dtype])
        with torch.cuda.device(z.device):
            code = fn(y.data_ptr(), xh.data_ptr(), z.data_ptr(), dskip.data_ptr(),
                      norm_g.data_ptr(), out.data_ptr(), rstd.data_ptr(), b, s, di, p, groups,
                      float(eps), _stream(z.device))
        _launched(code, "mamba_gate_norm_fwd", B=b, S=s, di=di, P=p, groups=groups)
        NORM_LAUNCHES += 1
        NORM_GROUPED_LAUNCHES += groups > 1
    return out, rstd


def skip_gate_norm_bwd(dout, y, xh, z, dskip, norm_g, rstd, groups: int = 1):
    """Launch ``mamba_gate_norm_bwd`` and the sums of its partials: (dy,
    dxh's skip term, dz in z's dtype, ddskip [H], dnorm_g [di] float32) for
    the incoming gradient ``dout``."""
    global NORM_BWD_LAUNCHES, NORM_GROUPED_BWD_LAUNCHES
    check_no_grad("skip_gate_norm_bwd", dout, y, xh, z, dskip, norm_g, rstd)
    b, s, di, p = _norm_form(y, xh, z, dskip, norm_g, groups)
    _check(dout, "dout", z.dtype, (b, s, di))
    _check(rstd, "rstd", torch.float32, (b * s * groups,), aligned=False)
    _on_cuda(dout=dout, y=y, xh=xh, z=z, dskip=dskip, norm_g=norm_g, rstd=rstd)
    dy, dxh, dz = torch.empty_like(y), torch.empty_like(xh), torch.empty_like(z)
    ddskip = torch.zeros_like(dskip)
    dg = torch.zeros_like(norm_g)
    if z.numel():
        lib = _lib()
        part = torch.empty(lib.mamba_gate_norm_bwd_scratch(b, s, di), dtype=torch.float32,
                           device=z.device)
        fn = getattr(lib, "mamba_gate_norm_bwd_" + _DTYPES[z.dtype])
        with torch.cuda.device(z.device):
            code = fn(dout.data_ptr(), y.data_ptr(), xh.data_ptr(), z.data_ptr(),
                      dskip.data_ptr(), norm_g.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
                      dxh.data_ptr(), dz.data_ptr(), ddskip.data_ptr(), dg.data_ptr(),
                      part.data_ptr(), b, s, di, p, groups, _stream(z.device))
        _launched(code, "mamba_gate_norm_bwd", B=b, S=s, di=di, P=p, groups=groups)
        NORM_BWD_LAUNCHES += 1
        NORM_GROUPED_BWD_LAUNCHES += groups > 1
    return dy, dxh, dz, ddskip, dg
