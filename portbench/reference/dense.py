"""Plain float32 reference of a dense decoder (Mistral-NeMo's block): RMSNorm,
GQA attention with RoPE on the two halves of each head, a SwiGLU MLP, an
untied unembedding and the mean next-token cross-entropy.  The inputs are
token ids looked up in the embedding table, or, for a later stage of a
pipeline, the hidden states the stage before it hands over.

Sizes come from the configuration file's ``model`` block; parameters are
the flat per-layer leaves of ``reference.train``.  Attention is exact
causal softmax, taken a block of query rows at a time (``_Attention``) so
that no [S, S] score matrix is ever whole; each block computes its rows
against every key up to its last row.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

from .common import Prec, checkpointed, cross_entropy, fq, gq, mm, rms_norm

__all__ = ["LAYER_KEYS", "loss"]

LAYER_KEYS = ("ln1", "attn.wq", "attn.wk", "attn.wv", "attn.wo",
              "ln2", "mlp.wi", "mlp.wg", "mlp.wo")
#: query rows per block of the attention
BLOCK = 512


def rope_tables(s: int, hd: int, theta: float, device):
    """cos, sin [S, hd/2]: position times 1/theta^(2i/hd), the frequencies
    rounded once from float64."""
    exponent = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    freqs = (1.0 / (theta ** exponent.double())).float()
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rotate(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class _Attention(torch.autograd.Function):
    """Causal GQA attention, q [B, Hkv, R, S, D], k/v [B, Hkv, S, D], by
    blocks of query rows; the backward computes each block's probabilities
    again from the saved log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        s = q.shape[3]
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:4], dtype=q.dtype, device=q.device)
        for i0 in range(0, s, BLOCK):
            i1 = min(i0 + BLOCK, s)
            sc = torch.einsum("bkrqd,bktd->bkrqt", q[:, :, :, i0:i1], k[:, :, :i1]) * scale
            sc = sc.masked_fill(_future(i0, i1, q.device), float("-inf"))
            lse[..., i0:i1] = torch.logsumexp(sc, -1)
            p = torch.exp(sc - lse[..., i0:i1, None])
            o[:, :, :, i0:i1] = torch.einsum("bkrqt,bktd->bkrqd", p, v[:, :, :i1])
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale, s = ctx.scale, q.shape[3]
        dq, dk, dv = torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
        delta = (do * o).sum(-1)
        for i0 in range(0, s, BLOCK):
            i1 = min(i0 + BLOCK, s)
            qb, dob = q[:, :, :, i0:i1], do[:, :, :, i0:i1]
            sc = torch.einsum("bkrqd,bktd->bkrqt", qb, k[:, :, :i1]) * scale
            sc = sc.masked_fill(_future(i0, i1, q.device), float("-inf"))
            p = torch.exp(sc - lse[..., i0:i1, None])
            dv[:, :, :i1] += torch.einsum("bkrqt,bkrqd->bktd", p, dob)
            dp = torch.einsum("bkrqd,bktd->bkrqt", dob, v[:, :, :i1])
            ds = p * (dp - delta[..., i0:i1, None]) * scale
            dq[:, :, :, i0:i1] = torch.einsum("bkrqt,bktd->bkrqd", ds, k[:, :, :i1])
            dk[:, :, :i1] += torch.einsum("bkrqt,bkrqd->bktd", ds, qb)
        return dq, dk, dv, None


def _future(i0: int, i1: int, device) -> torch.Tensor:
    """[rows, keys] True where key j lies after query row i."""
    rows = torch.arange(i0, i1, device=device)[:, None]
    return torch.arange(i1, device=device)[None, :] > rows


def attention(q, k, v, prec: Prec):
    """q [B, Hq, S, D], k/v [B, Hkv, S, D] -> [B, Hq, S, D]."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    q5 = fq(q, prec).reshape(b, hkv, hq // hkv, s, d)
    o = _Attention.apply(q5, fq(k, prec), fq(v, prec), d ** -0.5)
    return gq(o.reshape(b, hq, s, d), prec)


def _block(cfg: Dict, prec: Prec, x, cos, sin, ln1, wq, wk, wv, wo, ln2, wi, wg, w2):
    b, s, _ = x.shape
    hq, hkv, hd, eps = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["norm_eps"]
    h = rms_norm(x, ln1, eps)
    q = mm(h, wq, prec).reshape(b, s, hq, hd).transpose(1, 2)
    k = mm(h, wk, prec).reshape(b, s, hkv, hd).transpose(1, 2)
    v = mm(h, wv, prec).reshape(b, s, hkv, hd).transpose(1, 2)
    o = attention(rotate(q, cos, sin), rotate(k, cos, sin), v, prec)
    x = x + mm(o.transpose(1, 2).reshape(b, s, hq * hd), wo, prec)
    h2 = rms_norm(x, ln2, eps)
    return x + mm(mm(h2, wi, prec) * F.silu(mm(h2, wg, prec)), w2, prec)


def loss(p: Dict[str, torch.Tensor], cfg: Dict, batch: Dict[str, torch.Tensor],
         prec: Prec) -> torch.Tensor:
    labels = batch["labels"].long()
    b, s = labels.shape
    cos, sin = rope_tables(s, cfg["head_dim"], cfg["rope_theta"], labels.device)
    x = p["embed"][batch["tokens"].long()] if "tokens" in batch else batch["embeddings"].float()
    block = functools.partial(_block, cfg, prec)
    for i in range(cfg["n_layers"]):
        x = checkpointed(block, x, cos, sin, *(p[f"layers.{i}.{k}"] for k in LAYER_KEYS))
    h = rms_norm(x, p["final_norm"], cfg["norm_eps"])
    return cross_entropy(h.reshape(b * s, -1), p["unembed"], labels.reshape(-1), prec)
