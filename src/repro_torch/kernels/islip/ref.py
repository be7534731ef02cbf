"""Batched iSLIP matching, plain PyTorch version.

The counterpart of the JAX package's ``kernels/islip/ref.py``
(``islip_ref``): the cycle-level switch's iSLIP step with a batch axis
written out.  ``iters`` request/grant/accept rounds; every output grants the
first free requesting input at or after its grant pointer, every input
accepts the first grant at or after its accept pointer, and pointers move
only on first-round accepts (McKeown's rule).  Exact integer arithmetic, so
the CUDA kernel (``kernel.py``) is held to it bit for bit.

The CPU tests run this, ``switch/scheduler.py`` runs it for CPU tensors,
and ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import torch

__all__ = ["islip_ref", "rot_pick"]


def rot_pick(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """One-hot of the first set bit of each row of v [..., n] (bool) at or
    after the rotating pointer p [...] (floor modulo n)."""
    n = v.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=v.device)
    score = torch.where(v, (idx - p[..., None]) % n, n + 1)
    sel = score.argmin(-1, keepdim=True)
    return (idx == sel) & v.any(-1, keepdim=True)


def islip_ref(req: torch.Tensor, gptr: torch.Tensor, aptr: torch.Tensor,
              *, iters: int = 2):
    """req [B, N, N] int 0/1 -> (match [B, N, N] int32, gptr', aptr' [B, N] int32)."""
    n = req.shape[-1]
    req = req != 0
    gptr = gptr.to(torch.int32)
    aptr = aptr.to(torch.int32)
    match = torch.zeros_like(req)
    new_g, new_a = gptr, aptr
    for it in range(iters):
        free = ~match.any(2, keepdim=True) & ~match.any(1, keepdim=True)
        # grant: each output (column) picks a requesting input
        grants = rot_pick((req & free).transpose(1, 2), gptr).transpose(1, 2)
        # accept: each input (row) picks among its grants
        accepts = rot_pick(grants, aptr)
        match = match | accepts
        if it == 0:                     # McKeown's pointer rule
            g_in = accepts.to(torch.int8).argmax(1)
            a_out = accepts.to(torch.int8).argmax(2)
            new_g = torch.where(accepts.any(1), (g_in + 1) % n, gptr).to(torch.int32)
            new_a = torch.where(accepts.any(2), (a_out + 1) % n, aptr).to(torch.int32)
    return match.to(torch.int32), new_g, new_a
