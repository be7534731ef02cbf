"""The public ring-scan op: the finite-VOQ admission scan for a batch.

Device policy, as in the other families: tensors on a CUDA device launch
the hand-written kernel (``kernel.ring_scan``); tensors on the CPU take the
plain PyTorch version (``ref.py``).  There is no fallback from one to the
other.

Memory: the scan carries a ``[B, N², d_max]`` float64 departure ring, 32
MiB a row at 64 ports and ``d_max`` 1,024.  Rows are independent, so the
batch runs in chunks of rows whose rings fit ``RING_BUDGET_BYTES`` (at
least one row a chunk), one launch each, as the JAX package's docstring
asks of very large sweeps.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import kernel
from .ref import ring_scan_ref

__all__ = ["RING_BUDGET_BYTES", "ring_rows_per_chunk", "ring_scan"]

#: device memory the rings of one chunk of rows may take
RING_BUDGET_BYTES = 2 << 30


def ring_rows_per_chunk(n_ports: int, d_max: int) -> int:
    """Rows whose rings fit ``RING_BUDGET_BYTES`` (at least one)."""
    return max(1, RING_BUDGET_BYTES // (n_ports * n_ports * d_max * 8))


def ring_scan(now, src, dst, svc, pipe, depth, mod, *, n_ports: int,
              d_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """now/src/dst [m], svc [B, m] float64, pipe/depth/mod [B], all on
    ``svc``'s device -> (end [B, m] float64, admit [B, m] bool).

    ``mod`` is each row's ring modulus ``min(max(depth, 1), m)`` and
    ``d_max`` a static ring size at or above ``max(mod)``."""
    b_n = svc.shape[0]
    step = ring_rows_per_chunk(n_ports, d_max)
    if svc.device.type == "cpu":
        run = lambda s, p, d, md: ring_scan_ref(         # noqa: E731
            now, src, dst, s, p, d, md, n_ports=n_ports, d_max=d_max)
    else:
        now_c = now.to(torch.float64).contiguous()
        src_c = src.to(torch.int32).contiguous()
        dst_c = dst.to(torch.int32).contiguous()
        run = lambda s, p, d, md: kernel.ring_scan(      # noqa: E731
            now_c, src_c, dst_c, s.t().contiguous(), p.contiguous(),
            d.to(torch.int32).contiguous(), md.to(torch.int32).contiguous(),
            n_ports=n_ports, d_max=d_max)
    if b_n <= step:
        return run(svc, pipe, depth, mod)
    parts = [run(svc[r:r + step], pipe[r:r + step], depth[r:r + step],
                 mod[r:r + step]) for r in range(0, b_n, step)]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))
