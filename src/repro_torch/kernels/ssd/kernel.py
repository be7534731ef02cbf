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
``ref.ssd_chunked_ref`` within ``chip_smoke.SSD_BWD_TOL``.  Two paths, as
``plan_bwd`` says: x, B and C in bfloat16 at P 64, N 128 (the training
path's form) on ``wgmma`` (four launches: each chunk's local state deltas,
the chains over chunks, the chunk terms with dB and dC summed over a
group's heads in registers, da's sum; every operand that holds float32
digits rounded to bfloat16 once), every other form on the FMA pipes
(three launches).  ``BWD_LAUNCHES`` counts calls, ``BWD_LAUNCHES_WGMMA``
those that the library reports it ran on ``wgmma``; ``bwd_passes`` runs
one launch alone, for timing.  Both bindings raise when grad mode is on
and an input requires a gradient: ``ops.SSDScanFn`` is the differentiable
op.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import check_launch, check_no_grad, check_tensor, library

__all__ = ["LAUNCHES", "BWD_LAUNCHES", "BWD_LAUNCHES_WGMMA", "HEAD_DIMS", "STATE_DIMS",
           "CHUNK", "P_SPLIT", "ssd_scan", "ssd_scan_bwd", "bwd_passes", "bwd_scratch_floats",
           "plan", "plan_bwd", "wgmma_smem", "bwd_wgmma_smem"]

#: calls that launched the kernels (three launches each) since the counter
#: was last reset (``chip_smoke.py`` sets it to 0 before the main path and
#: reads it after)
LAUNCHES = 0
#: calls of the gradient kernel, and those of them on the ``wgmma`` path as
#: the library reports it
BWD_LAUNCHES = 0
BWD_LAUNCHES_WGMMA = 0
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


#: the gradient's ``wgmma`` path: (P, N) with x, B and C in bfloat16
BWD_WGMMA_PN = (64, 128)


def plan_bwd(x_dtype: torch.dtype, bc_dtype: torch.dtype, p: int, n: int, s: int, *,
             bh: int = 1, groups: int = 1) -> dict:
    """How the gradient kernel runs x [BH, S, P] of ``x_dtype`` with B/C
    [G, S, N] of ``bc_dtype`` (``bh`` heads, ``groups`` rows of B/C): its
    path (``"wgmma"`` for bfloat16 x, B and C at P 64, N 128, else
    ``"fma"``), its launches in order (the names ``bwd_passes`` takes bit by
    bit), each launch's grid, threads and dynamic shared memory, the ring's
    stages, the operands rounded to bfloat16 once, and the chunk count
    ``nc``."""
    nc = -(-s // CHUNK)
    if (x_dtype == torch.bfloat16 and bc_dtype == torch.bfloat16
            and (p, n) == BWD_WGMMA_PN):
        xt, nt, vec = CHUNK * p * 2, CHUNK * n * 2, 2 * CHUNK * 4
        # x, gy, B, C tiles, the vector, an mbarrier; 1,024 bytes to align
        delta = 1024 + 2 * xt + 2 * nt + vec + 8
        # B and C, C.B^T and B.C^T in float32, x o w and gy o exp(cum), the
        # ring (x, gy, S_c, E_c a stage) and its vectors, five per-row sums
        # and 8 partials, mbarriers (a stage each and one for B and C)
        stages = 2
        chunk = (1024 + 2 * nt + 2 * CHUNK * CHUNK * 4 + 2 * xt
                 + stages * (2 * xt + 2 * nt + vec) + (5 * CHUNK + 8) * 4 + 8 * (stages + 1))
        return {"path": "wgmma", "launches": ("delta", "scan", "chunk", "da"),
                "grid": {"delta": (nc, bh), "scan": (-(-bh * p * n // 8 // 256), 2),
                         "chunk": (nc, groups), "da": (-(-bh // 256),)},
                "threads": {"delta": 128, "scan": 256, "chunk": 128, "da": 256},
                "smem": {"delta": delta, "scan": 0, "chunk": chunk, "da": 0},
                "stages": stages, "chunk_steps": CHUNK, "nc": nc,
                "rounded_to_bf16": ("x o w", "gy o exp(cum)", "A", "W", "dS_c", "dE_c",
                                    "S_c", "E_c")}
    ps = min(p, 32)
    chunk = 4 * (2 * CHUNK * (p + 1) + 2 * CHUNK * (n + 1) + 3 * CHUNK * (CHUNK + 1)
                 + 2 * ps * (n + 1) + 4 * CHUNK + 16)
    return {"path": "fma", "launches": ("states", "chunk", "reduce"),
            "grid": {"states": (bh, p // 16, 2), "chunk": (nc, bh),
                     "reduce": (max(1, min(-(-s * n * groups // 256), 4096)),)},
            "threads": {"states": 256, "chunk": 256, "reduce": 256},
            "smem": {"states": 4 * (CHUNK * 16 + CHUNK * n + 3 * CHUNK), "chunk": chunk,
                     "reduce": 0},
            "stages": 1, "chunk_steps": CHUNK, "nc": nc, "rounded_to_bf16": ()}


def _lib_bwd():
    lib = library("ssd_bwd")
    if not getattr(lib, "_spac_typed", False):
        for tx in _SUFFIX.values():
            for tb in _SUFFIX.values():
                fn = getattr(lib, f"ssd_scan_bwd_{tx}_{tb}")
                fn.argtypes = [_P] * 12 + [_I] * 6 + [_P, ctypes.POINTER(_I)]
                fn.restype = ctypes.c_int
        lib.ssd_scan_bwd_wgmma_smem.argtypes = [_I]
        lib.ssd_scan_bwd_wgmma_smem.restype = ctypes.c_int
        lib._spac_typed = True
    return lib


def bwd_wgmma_smem(launch: str) -> int:
    """The ``wgmma`` path's dynamic shared memory of ``launch`` (``"delta"``
    or ``"chunk"``) as the built kernel sets it (builds the library;
    ``plan_bwd`` must agree)."""
    return int(_lib_bwd().ssd_scan_bwd_wgmma_smem(0 if launch == "delta" else 1))


def bwd_scratch_floats(bh: int, s: int, p: int, n: int,
                       x_dtype: torch.dtype = torch.float32,
                       bc_dtype: torch.dtype = torch.float32) -> int:
    """float32 words of one gradient call's scratch, on the path
    ``plan_bwd`` picks.  ``wgmma``: the chunk deltas, overwritten by the
    chunk-start states and the reverse carries, [BH, NC, P, N] bf16 each
    (NC = ceil(S / CHUNK)), each chunk's cum and dt [BH, NC, 2, CHUNK] and
    da's per-chunk parts [BH, NC].  ``fma``: the states and carries in
    float32, per-head dB and dC [BH, S, N], and da's parts [BH, NC]."""
    nc = -(-s // CHUNK)
    if plan_bwd(x_dtype, bc_dtype, p, n, s)["path"] == "wgmma":
        return bh * nc * p * n + bh * nc * 2 * CHUNK + bh * nc
    return 2 * bh * nc * p * n + 2 * bh * s * n + bh * nc


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, dy: torch.Tensor):
    """Launch the gradient kernel on ``x``'s CUDA device: (dx, ddt, da, db,
    dc) of ``ssd_scan(x, dt, a, b, c)`` for the incoming gradient ``dy``."""
    return bwd_passes(x, dt, a, b, c, dy)


def bwd_passes(x, dt, a, b, c, dy, *, passes: int | None = None,
               scratch: torch.Tensor | None = None):
    """``ssd_scan_bwd``'s launches, or some of them alone (``passes``: bit k
    the k-th of ``plan_bwd``'s launches; all by default) on ``scratch``
    (float32, ``bwd_scratch_floats`` words, which the earlier launches
    fill and the later ones read), for timing one launch alone.  Returns
    (dx, ddt, da, db, dc); only the outputs of the launches run are
    written."""
    global BWD_LAUNCHES, BWD_LAUNCHES_WGMMA
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
    plan = plan_bwd(x.dtype, b.dtype, p, n, s)
    if plan["path"] == "wgmma":
        for name, t in (("x", x), ("dy", dy), ("b", b), ("c", c)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary (TMA loads it)")
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    da = torch.zeros_like(a)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    if x.numel() == 0:
        return dx, ddt, da, db.zero_(), dc.zero_()
    words = bwd_scratch_floats(bh, s, p, n, x.dtype, b.dtype)
    if scratch is None:
        scratch = torch.empty(words, dtype=torch.float32, device=dev)
    check_tensor(scratch, "scratch", torch.float32, (words,), dev)
    mask = (1 << len(plan["launches"])) - 1 if passes is None else int(passes)
    fn = getattr(_lib_bwd(), f"ssd_scan_bwd_{_SUFFIX[x.dtype]}_{_SUFFIX[b.dtype]}")
    wgmma = _I(0)                       # the path the library launched
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), dy.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                  c.data_ptr(), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
                  db.data_ptr(), dc.data_ptr(), scratch.data_ptr(), bh, s, p, n, bh // g,
                  mask, stream, ctypes.byref(wgmma))
    check_launch(code, "ssd_scan_bwd")
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_WGMMA += wgmma.value
    return dx, ddt, da, db, dc
