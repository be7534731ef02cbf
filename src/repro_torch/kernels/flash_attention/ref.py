"""Plain PyTorch versions of the attention kernel.

``attention_ref`` is the port of the JAX package's oracle
``kernels/flash_attention/ref.py`` (exact softmax attention in float32).
``blockwise_ref`` is the plain version of the hand-written kernel
(``csrc/flash_attention.cu``): the arithmetic of the reference's
``models/attention.py`` ``blockwise_attention`` — float32 scores scaled by
``1/sqrt(D)``, the finite ``-1e30`` mask with the ``T - S`` row offset and
the optional sliding window, an online softmax over key blocks, P rounded
to the input dtype before the PV product, float32 accumulation — with GQA
by indexing.  It takes any S and T (a ragged last block is shorter).  The
CPU runs it, and ``chip_smoke.py`` holds the kernel against it on the card.
With ``return_lse=True`` it also gives each row's log-sum-exp of its
scaled scores, ``m + ln l`` from the online softmax: the plain counterpart
of what the kernel writes for the gradient.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "attention_ref", "blockwise_ref"]

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q [BH, S, D], k/v [BH, T, D] -> [BH, S, D]."""
    d = q.shape[-1]
    s = torch.einsum("bsd,btd->bst", q.float(), k.float())
    s = s / (d ** 0.5)
    if causal:
        sq, tk = s.shape[-2:]
        mask = torch.tril(torch.ones((sq, tk), dtype=torch.bool, device=q.device),
                          diagonal=tk - sq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bst,btd->bsd", p, v.float()).to(q.dtype)


def blockwise_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, block_q: int = 512,
                  block_k: int = 1024, return_lse: bool = False):
    """q [B, Hq, S, D], k/v [B, Hkv, T, D] -> [B, Hq, S, D] (q's dtype),
    and with ``return_lse`` also the log-sum-exp [B, Hq, S] (float32)."""
    b, h, s, hd = q.shape
    hkv, t = k.shape[1], k.shape[2]
    rep = h // hkv
    bq, bk = min(block_q, s), min(block_k, t)
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    q5 = q.reshape(b, hkv, rep, s, hd)
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for q0 in range(0, s, bq):
        qi = q5[:, :, :, q0:q0 + bq].float()          # [b, hkv, rep, nq, hd]
        nq = qi.shape[3]
        rows = q0 + torch.arange(nq, device=dev)[:, None] + (t - s)
        m = torch.full((b, hkv, rep, nq, 1), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, rep, nq, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, rep, nq, hd), dtype=torch.float32, device=dev)
        for k0 in range(0, t, bk):
            ks, vs = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
            sc = torch.einsum("bkrqd,bkKd->bkrqK", qi, ks) * scale
            cols = k0 + torch.arange(ks.shape[2], device=dev)[None, :]
            if causal:
                sc = sc.masked_fill(rows < cols, NEG_INF)
            if window:
                sc = sc.masked_fill(rows - cols >= window, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bkrqK,bkKd->bkrqd",
                                             p.to(q.dtype).float(), vs)
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)).to(q.dtype))
        lses.append((m + torch.log(l))[..., 0])
    o = torch.cat(outs, dim=3).reshape(b, h, s, hd)
    if return_lse:
        return o, torch.cat(lses, dim=3).reshape(b, h, s)
    return o
