"""Plain PyTorch versions of the SSD scan.

``ssd_ref`` is the port of the JAX package's oracle ``kernels/ssd/ref.py``
(the sequential state-space recurrence); ``ssd_chunked_ref`` is the port of
``kernels/ssd/ops.py`` ``ssd_chunked`` (the chunk-parallel algorithm, with
the final state on request), and the plain version of the hand-written
kernel (``csrc/ssd.cu``), which computes the same function with its own
chunk.  The CPU runs it, and ``chip_smoke.py`` holds the kernel against it
on the card.

Shapes: x [BH, S, P], dt [BH, S], a [BH], b/c [BH, S, N] -> y [BH, S, P].
"""

from __future__ import annotations

import torch

__all__ = ["ssd_ref", "ssd_chunked_ref"]


def ssd_ref(x, dt, a, b, c) -> torch.Tensor:
    """Sequential scan, float32 state; y in x's dtype."""
    bh, s, p = x.shape
    n = b.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    state = torch.zeros((bh, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a)[:, None, None]
        state = state * decay + dtf[:, t, None, None] * (xf[:, t, :, None] * bf[:, t, None, :])
        ys.append(torch.einsum("hpn,hn->hp", state, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked_ref(x, dt, a, b, c, *, chunk: int = 128,
                    return_state: bool = False):
    """Chunk-parallel SSD (the reference's ``ssd_chunked``); S % chunk == 0."""
    bh, s, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    xc = x.reshape(bh, nc, chunk, p).float()
    dtc = dt.reshape(bh, nc, chunk).float()
    bc = b.reshape(bh, nc, chunk, n).float()
    cc = c.reshape(bh, nc, chunk, n).float()
    cum = torch.cumsum(dtc * a[:, None, None], dim=-1)
    # intra-chunk causal term, masked before the exponential (where, not a
    # 0/1 product: exp(cum_i - cum_j) overflows for j > i)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    diff = cum[..., :, None] - cum[..., None, :]
    l_mat = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    scores = torch.einsum("hcin,hcjn->hcij", cc, bc) * l_mat * dtc[..., None, :]
    y_intra = torch.einsum("hcij,hcjp->hcip", scores, xc)
    # inter-chunk recurrence over [P, N] states
    total = cum[..., -1]
    w = torch.exp(total[..., None] - cum) * dtc
    chunk_state = torch.einsum("hcjp,hcjn->hcpn", xc * w[..., None], bc)
    state = torch.zeros((bh, p, n), dtype=torch.float32, device=x.device)
    states_in = []
    for i in range(nc):
        states_in.append(state)                        # state before chunk i
        state = state * torch.exp(total[:, i])[:, None, None] + chunk_state[:, i]
    states_in = torch.stack(states_in, dim=1)          # [BH, NC, P, N]
    y_inter = torch.einsum("hcin,hcpn->hcip", cc * torch.exp(cum)[..., None], states_in)
    y = (y_intra + y_inter).reshape(bh, s, p).to(x.dtype)
    if return_state:
        return y, state
    return y
