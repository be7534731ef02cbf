"""``gemm_ms_per_step``: device time a step spends in cuBLAS's matrix
products (kernels named nvjet, gemm, gemv, cutlass, xmma, cublas or
split-K), summed over the traced window and divided by its steps."""

from ._kernels import GEMM, Reading, group


def read(r: Reading):
    sec, calls = group(r, GEMM)
    if not calls or r.steps <= 0:
        return None
    return 1e3 * sec / r.steps
