"""``other_kernels_ms_per_step``: device time a step spends in operations
that are neither the port's hand-written kernels nor cuBLAS's products:
PyTorch's elementwise kernels and reductions, copies and fills."""

from ._kernels import GEMM, PORT, Reading


def read(r: Reading):
    if r.steps <= 0 or not r.kernels:
        return None
    sec = sum(s for name, (s, _) in r.kernels.items()
              if not GEMM.search(name) and not any(p.search(name) for p in PORT))
    return 1e3 * sec / r.steps
