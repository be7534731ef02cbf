"""Binding of the hand-written SSD scan (``csrc/ssd.cu``).

Replaces the JAX package's Pallas kernel ``kernels/ssd/kernel.py``
``ssd_scan``, at the call site of its XLA twin ``kernels/ssd/ops.py``
``ssd_chunked``.  Every accepted form runs on ``wgmma``: a head is split
across blocks along P (``P_SPLIT`` columns each), each block walks the
head's chunks of ``CHUNK`` steps with its slice of the float32 state in
registers, and every product is a bf16 tensor-core product with float32
accumulation, an operand that holds float32 digits split into a bf16 hi and
lo part (three passes).  The function is bound by bytes; the three passes
make the kernel's own work larger (see the note at the top of the CUDA
source).  ``plan`` says how a call runs.

Contract: ``ssd_scan(x, dt, a, b, c, return_state=)`` for x [BH, S, P]
(float32 or bfloat16), dt [BH, S] and a [BH] float32, and b/c [G, S, N]
both float32 or both bfloat16 (G divides BH; row g serves heads
g·BH/G .. (g+1)·BH/G - 1), all contiguous on one CUDA device, x starting on
a 16-byte boundary, P in 32/64/128, N in 16/32/64/128 and any S, gives y
[BH, S, P] in x's dtype (and the final state [BH, P, N] float32), equal to
``ref.ssd_chunked_ref`` (on b and c as float32) up to float32 rounding.
B and C in bfloat16 are exact in one bf16 pass, so they are read as they
come.  A call is three launches on its stream: ``ssd_split_bc`` (B and C
as bf16 planes), ``ssd_chunk_vec`` (each chunk's scan of dt a) and the scan
``ssd_wgmma``.  ``LAUNCHES`` counts calls, one for each such triple.

``ssd_scan_bwd(x, dt, a, b, c, dy)`` launches the gradient kernel
(``csrc/ssd_bwd.cu``, which replaces no Pallas kernel: the reference takes
this gradient by autodiff of ``ssd_chunked``) for the same forms, giving
(dx, ddt, da, db, dc) in the dtypes of x, dt, a, b and c, with db and dc
summed over each group's heads, equal to autograd of
``ref.ssd_chunked_ref`` up to float32 rounding.  A call is three launches
(``ssd_bwd_states``, ``ssd_bwd_chunk``, ``ssd_bwd_reduce``);
``BWD_LAUNCHES`` counts calls.  Both bindings raise when grad mode is on
and an input requires a gradient: ``ops.SSDScanFn`` is the differentiable
op.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import check_launch, check_no_grad, check_tensor, library

__all__ = ["LAUNCHES", "BWD_LAUNCHES", "HEAD_DIMS", "STATE_DIMS", "CHUNK", "P_SPLIT",
           "ssd_scan", "ssd_scan_bwd", "bwd_scratch_floats", "plan", "wgmma_smem"]

#: calls that launched the kernels (three launches each) since the counter
#: was last reset (``chip_smoke.py`` sets it to 0 before the main path and
#: reads it after)
LAUNCHES = 0
#: calls of the gradient kernel (three launches each)
BWD_LAUNCHES = 0
HEAD_DIMS = (32, 64, 128)
STATE_DIMS = (16, 32, 64, 128)
#: steps per chunk: one 64-row wgmma tile
CHUNK = 64
#: columns of P a block takes (``PS`` in the CUDA source; 16 measured
#: slower at mamba2-780m's prefill, PERF.md)
P_SPLIT = 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def plan(dtype: torch.dtype, p: int, n: int, bc_dtype: torch.dtype = torch.float32) -> dict:
    """How the kernel runs x [.., P] of ``dtype`` with B/C of ``bc_dtype``
    and state dim ``n``: the P split (columns per block, blocks per head),
    the chunk, threads, ring stages, the state's rows (N padded to 64 for
    wgmma's M side), whether B/C are split into hi/lo, and the dynamic
    shared memory in bytes, as ``csrc/ssd.cu``'s ``Cfg`` sets it."""
    nw = max(n, 64)
    split = bc_dtype == torch.float32
    item = 4 if dtype == torch.float32 else 2
    # a stage: the B/C planes, the raw x slice, the chunk's four [CHUNK]
    # float vectors (cum, dt, e^cum, w)
    stage = ((4 if split else 2) * CHUNK * nw * 2 + CHUNK * P_SPLIT * item
             + 4 * CHUNK * 4)
    stages = 2 if split else 1                     # the ring (``Cfg::STAGES``)
    x_tiles = (2 if item == 4 else 1) + 2          # x hi (, lo), x o w hi, lo
    # 1,024 bytes to align the tiles, the ring, the x-side tiles, the state's
    # hi/lo tiles, one mbarrier a stage
    smem = (1024 + stages * stage + x_tiles * P_SPLIT * 128 + 2 * P_SPLIT * nw * 2
            + 8 * stages)
    return {"p_split": P_SPLIT, "blocks_per_head": p // P_SPLIT,
            "chunk": CHUNK, "threads": 128, "stages": stages, "state_rows": nw,
            "bc_split": split, "smem": smem}


def _lib():
    lib = library("ssd")
    if not getattr(lib, "_spac_typed", False):
        for sfx in _SUFFIX.values():
            fn = getattr(lib, "ssd_scan_" + sfx)
            fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
            fn.restype = ctypes.c_int
        lib.ssd_scan_smem.argtypes = [_I, _I, _I]
        lib.ssd_scan_smem.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def wgmma_smem(dtype: torch.dtype, n: int, bc_dtype: torch.dtype = torch.float32) -> int:
    """The dynamic shared memory the built kernel sets (builds the library;
    ``plan`` must agree)."""
    return int(_lib().ssd_scan_smem(int(dtype == torch.bfloat16),
                                    int(bc_dtype == torch.bfloat16), n))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, return_state: bool = False):
    """Launch the kernel on ``x``'s CUDA device."""
    global LAUNCHES
    check_no_grad("ssd_scan", x, dt, a, b, c)
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}: the SSD kernel takes CUDA tensors "
                         "(the plain version is ref.ssd_chunked_ref)")
    if x.dim() != 3 or b.dim() != 3:
        raise ValueError("x must be [BH, S, P] and b/c [G, S, N]")
    bh, s, p = x.shape
    g, n = b.shape[0], b.shape[-1]
    if x.dtype not in _SUFFIX or b.dtype not in _SUFFIX:
        raise ValueError(f"x has dtype {x.dtype} and b {b.dtype}; the kernel takes "
                         "float32 or bfloat16")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"P={p}, N={n}: the kernel takes P in {HEAD_DIMS} and "
                         f"N in {STATE_DIMS}")
    if g < 1 or bh % g:
        raise ValueError(f"{g} rows of B/C do not divide {bh} heads")
    dev = x.device
    check_tensor(x, "x", x.dtype, (bh, s, p), dev)
    check_tensor(dt, "dt", torch.float32, (bh, s), dev)
    check_tensor(a, "a", torch.float32, (bh,), dev)
    check_tensor(b, "b", b.dtype, (g, s, n), dev)
    check_tensor(c, "c", b.dtype, (g, s, n), dev)
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (TMA loads it)")
    y = torch.empty_like(x)
    state = (torch.zeros((bh, p, n), dtype=torch.float32, device=dev)
             if return_state else None)
    if x.numel():
        bc_bf16 = b.dtype == torch.bfloat16
        # scratch: B and C as bf16 planes (hi, and lo where float32), N
        # padded to 64; then each chunk's four [CHUNK] float vectors
        planes = (2 if bc_bf16 else 4) * g * s * max(n, 64) * 2
        scratch = torch.empty(planes + bh * -(-s // CHUNK) * 4 * CHUNK * 4,
                              dtype=torch.uint8, device=dev)
        fn = getattr(_lib(), "ssd_scan_" + _SUFFIX[x.dtype])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                      c.data_ptr(), y.data_ptr(),
                      state.data_ptr() if return_state else None, scratch.data_ptr(),
                      bh, s, p, n, bh // g, int(bc_bf16), stream)
        check_launch(code, "ssd_scan")
        LAUNCHES += 1
    return (y, state) if return_state else y


def _lib_bwd():
    lib = library("ssd_bwd")
    if not getattr(lib, "_spac_typed", False):
        for tx in _SUFFIX.values():
            for tb in _SUFFIX.values():
                fn = getattr(lib, f"ssd_scan_bwd_{tx}_{tb}")
                fn.argtypes = [_P] * 12 + [_I] * 5 + [_P]
                fn.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def bwd_scratch_floats(bh: int, s: int, p: int, n: int) -> int:
    """float32 scratch of one gradient call: the chunk-start states and the
    reverse carries [BH, NC, P, N] (NC = ceil(S / CHUNK)), per-head dB and
    dC [BH, S, N], and da's per-chunk parts [BH, NC]."""
    nc = -(-s // CHUNK)
    return 2 * bh * nc * p * n + 2 * bh * s * n + bh * nc


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, dy: torch.Tensor):
    """Launch the gradient kernel on ``x``'s CUDA device: (dx, ddt, da, db,
    dc) of ``ssd_scan(x, dt, a, b, c)`` for the incoming gradient ``dy``."""
    global BWD_LAUNCHES
    check_no_grad("ssd_scan_bwd", x, dt, a, b, c, dy)
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}: the SSD gradient kernel takes CUDA "
                         "tensors (the plain version is autograd of "
                         "ref.ssd_chunked_ref)")
    if x.dim() != 3 or b.dim() != 3:
        raise ValueError("x must be [BH, S, P] and b/c [G, S, N]")
    bh, s, p = x.shape
    g, n = b.shape[0], b.shape[-1]
    if x.dtype not in _SUFFIX or b.dtype not in _SUFFIX:
        raise ValueError(f"x has dtype {x.dtype} and b {b.dtype}; the kernel takes "
                         "float32 or bfloat16")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"P={p}, N={n}: the kernel takes P in {HEAD_DIMS} and "
                         f"N in {STATE_DIMS}")
    if g < 1 or bh % g:
        raise ValueError(f"{g} rows of B/C do not divide {bh} heads")
    dev = x.device
    check_tensor(x, "x", x.dtype, (bh, s, p), dev)
    check_tensor(dy, "dy", x.dtype, (bh, s, p), dev)
    check_tensor(dt, "dt", torch.float32, (bh, s), dev)
    check_tensor(a, "a", torch.float32, (bh,), dev)
    check_tensor(b, "b", b.dtype, (g, s, n), dev)
    check_tensor(c, "c", b.dtype, (g, s, n), dev)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    da = torch.zeros_like(a)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    if x.numel() == 0:
        return dx, ddt, da, db.zero_(), dc.zero_()
    scratch = torch.empty(bwd_scratch_floats(bh, s, p, n), dtype=torch.float32, device=dev)
    fn = getattr(_lib_bwd(), f"ssd_scan_bwd_{_SUFFIX[x.dtype]}_{_SUFFIX[b.dtype]}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), dy.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                  c.data_ptr(), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
                  db.data_ptr(), dc.data_ptr(), scratch.data_ptr(), bh, s, p, n, bh // g,
                  stream)
    check_launch(code, "ssd_scan_bwd")
    BWD_LAUNCHES += 1
    return dx, ddt, da, db, dc
