"""Plain float32 reference of a Mamba-2 language model: RMSNorm, then the
SSD mixer (input projections, a depthwise causal convolution over x, the
chunked state-space scan, the skip, the gated RMSNorm, the output
projection) in every layer, an untied unembedding and the mean next-token
cross-entropy.

B and C are one row per sequence (one group), shared by its heads.  The
scan is the chunk-parallel form of the recurrence
``h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T``, ``y_t = h_t C_t``, with the
intra-chunk decays masked before the exponential.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

from .common import Prec, checkpointed, cross_entropy, fq, gq, mm, rms_norm

__all__ = ["LAYER_KEYS", "loss", "ssd"]

LAYER_KEYS = ("ln1", "ssm.wz", "ssm.wx", "ssm.wb", "ssm.wc", "ssm.wdt", "ssm.conv_w",
              "ssm.a_log", "ssm.dskip", "ssm.dt_bias", "ssm.norm_g", "ssm.wo")
#: steps per chunk of the scan (the function does not depend on it)
CHUNK = 128


def causal_conv(x, w):
    """Depthwise causal convolution over the sequence: x [B, S, C], w [C, K];
    tap j multiplies the input j steps back."""
    k = w.shape[-1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    s = x.shape[1]
    return sum(xp[:, k - 1 - j: k - 1 - j + s] * w[:, j] for j in range(k))


def ssd(x, dt, a, b, c, chunk: int = CHUNK):
    """x [B, H, S, P], dt [B, H, S], a [H], b/c [B, S, N] -> y [B, H, S, P]."""
    bs, h, s, p = x.shape
    n = b.shape[-1]
    L = chunk if s % chunk == 0 else s
    nc = s // L
    xc = x.reshape(bs, h, nc, L, p)
    dtc = dt.reshape(bs, h, nc, L)
    bc = b.reshape(bs, nc, L, n)
    cc = c.reshape(bs, nc, L, n)
    cum = torch.cumsum(dtc * a[None, :, None, None], dim=-1)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    diff = cum[..., :, None] - cum[..., None, :]
    decay = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    y = torch.einsum("bhcij,bhcjp->bhcip", cb[:, None] * decay * dtc[..., None, :], xc)
    total = cum[..., -1]
    w = torch.exp(total[..., None] - cum) * dtc
    chunk_state = torch.einsum("bhcjp,bcjn->bhcpn", xc * w[..., None], bc)
    state = torch.zeros((bs, h, p, n), dtype=x.dtype, device=x.device)
    states = []
    for i in range(nc):
        states.append(state)
        state = state * torch.exp(total[:, :, i])[..., None, None] + chunk_state[:, :, i]
    y_inter = torch.einsum("bcin,bhcpn->bhcip", cc, torch.stack(states, dim=2))
    y = y + y_inter * torch.exp(cum)[..., None]
    return y.reshape(bs, h, s, p)


def _block(cfg: Dict, prec: Prec, x, ln1, wz, wx, wb, wc, wdt, conv_w, a_log, dskip,
           dt_bias, norm_g, wo):
    bs, s, _ = x.shape
    hp = cfg["ssm_headdim"]
    nh = cfg["d_model"] * cfg["ssm_expand"] // hp
    eps = cfg["norm_eps"]
    h = rms_norm(x, ln1, eps)
    z = mm(h, wz, prec)
    xi = F.silu(causal_conv(mm(h, wx, prec), conv_w))
    b = mm(h, wb, prec)
    c = mm(h, wc, prec)
    dt = F.softplus(mm(h, wdt, prec) + dt_bias)
    xh = xi.reshape(bs, s, nh, hp).transpose(1, 2)
    y = gq(ssd(fq(xh, prec), dt.transpose(1, 2), -torch.exp(a_log), fq(b, prec),
               fq(c, prec)), prec)
    y = y + xh * dskip[None, :, None, None]
    y = y.transpose(1, 2).reshape(bs, s, nh * hp) * F.silu(z)
    return x + mm(rms_norm(y, norm_g, eps), wo, prec)


def loss(p: Dict[str, torch.Tensor], cfg: Dict, batch: Dict[str, torch.Tensor],
         prec: Prec) -> torch.Tensor:
    tok, labels = batch["tokens"].long(), batch["labels"].long()
    b, s = tok.shape
    x = p["embed"][tok]
    block = functools.partial(_block, cfg, prec)
    for i in range(cfg["n_layers"]):
        x = checkpointed(block, x, *(p[f"layers.{i}.{k}"] for k in LAYER_KEYS))
    h = rms_norm(x, p["final_norm"], cfg["norm_eps"])
    return cross_entropy(h.reshape(b * s, -1), p["unembed"], labels.reshape(-1), prec)
