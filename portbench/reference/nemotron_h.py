"""Plain float32 reference of a Nemotron-H pipeline stage (NVIDIA
Nemotron-3-Nano-30B-A3B): one mixer a layer behind an RMSNorm and a
residual, in the order of the configuration's ``layer_pattern`` (M a
Mamba-2 mixer, E a mixture of experts, * attention), then the final norm,
an untied unembedding and the mean next-token cross-entropy.  The inputs
are the hidden states the stage before it hands over.

- M: z, x, B, C and dt from separate input projections; the depthwise
  causal conv with its bias and SiLU over x, over B and over C; B and C one
  row per group of heads (``ssm_groups`` groups of H / G consecutive
  heads); the chunked state-space scan of ``reference/ssm.py`` with each
  head reading its group's B and C (``ssd``); the skip D; the gate
  silu(z); an RMSNorm over each group of di / G channels; the output
  projection.
- E: the router's float32 logits through a sigmoid; the correction bias
  added only to choose the top-k experts over all of them; the chosen k
  scores normalised to sum one and scaled; relu² experts without a gate,
  computed for the held experts alone, each on exactly the tokens routed
  to it (nothing dropped), their weighted outputs summed in float32; one
  shared expert (relu²) on every token.
- *: GQA by blocks of query rows (``reference/dense.py``'s ``attention``),
  causal, with no position encoding.

Parameters are the flat per-layer leaves of ``reference.train``, numbered
within their kind: ``layers.<i>.mamba.*``, ``layers.<i>.moe.*``,
``layers.<i>.attn.*``.

Departures from the published model, each also the program's:

- the conv's taps are indexed by how far back they reach (tap j multiplies
  the input j steps back; ``nn.Conv1d`` stores them the other way round);
- the correction bias is not trained (the source moves it by a balancing
  rule outside the gradient, left out here): it chooses experts and carries
  no gradient, so it enters the loss times zero, which hands autograd the
  zero gradient the program's step gives a leaf no gradient reaches;
- only the held experts' part of the routed sum is computed (the other
  experts lie on other devices of the expert-parallel group);
- no load-balance loss.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

from .common import Prec, checkpointed, cross_entropy, fq, gq, mm, rms_norm
from .dense import attention
from .ssm import CHUNK, causal_conv

__all__ = ["KEYS", "loss", "ssd"]

#: each kind's leaves, in the order its block takes them
KEYS = {"mamba": ("ln1", "wz", "wx", "wb", "wc", "wdt", "conv_w", "conv_b", "bconv_w",
                  "bconv_b", "cconv_w", "cconv_b", "a_log", "dskip", "dt_bias", "norm_g",
                  "wo"),
        "moe": ("ln1", "router", "e_bias", "w1", "w2", "shared_w1", "shared_w2"),
        "attn": ("ln1", "wq", "wk", "wv", "wo")}
KINDS = {"M": "mamba", "E": "moe", "*": "attn"}


def ssd(x, dt, a, b, c, chunk: int = CHUNK):
    """x [B, H, S, P], dt [B, H, S], a [H], b/c [B, G, S, N], head h reading
    group h // (H / G) -> y [B, H, S, P]: ``reference/ssm.py``'s chunked form
    with a group axis."""
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[-1]
    r = h // g
    L = chunk if s % chunk == 0 else s
    nc = s // L
    xc = x.reshape(bs, g, r, nc, L, p)
    dtc = dt.reshape(bs, g, r, nc, L)
    bc = b.reshape(bs, g, nc, L, n)
    cc = c.reshape(bs, g, nc, L, n)
    cum = torch.cumsum(dtc * a.reshape(g, r)[None, :, :, None, None], dim=-1)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    diff = cum[..., :, None] - cum[..., None, :]
    decay = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    cb = torch.einsum("bgcin,bgcjn->bgcij", cc, bc)
    y = torch.einsum("bgrcij,bgrcjp->bgrcip", cb[:, :, None] * decay * dtc[..., None, :], xc)
    total = cum[..., -1]
    w = torch.exp(total[..., None] - cum) * dtc
    chunk_state = torch.einsum("bgrcjp,bgcjn->bgrcpn", xc * w[..., None], bc)
    state = torch.zeros((bs, g, r, p, n), dtype=x.dtype, device=x.device)
    states = []
    for i in range(nc):
        states.append(state)
        state = state * torch.exp(total[..., i])[..., None, None] + chunk_state[:, :, :, i]
    y_inter = torch.einsum("bgcin,bgrcpn->bgrcip", cc, torch.stack(states, dim=3))
    y = y + y_inter * torch.exp(cum)[..., None]
    return y.reshape(bs, h, s, p)


def _conv_silu(x, w, bias):
    return F.silu(causal_conv(x, w) + bias)


def _mamba(cfg: Dict, prec: Prec, x, ln1, wz, wx, wb, wc, wdt, conv_w, conv_b, bconv_w,
           bconv_b, cconv_w, cconv_b, a_log, dskip, dt_bias, norm_g, wo):
    bs, s, _ = x.shape
    hp, nh, g, n = cfg["ssm_headdim"], cfg["ssm_nheads"], cfg["ssm_groups"], cfg["ssm_state"]
    eps = cfg["norm_eps"]
    h = rms_norm(x, ln1, eps)
    z = mm(h, wz, prec)
    xi = _conv_silu(mm(h, wx, prec), conv_w, conv_b)
    b = _conv_silu(mm(h, wb, prec), bconv_w, bconv_b).reshape(bs, s, g, n).transpose(1, 2)
    c = _conv_silu(mm(h, wc, prec), cconv_w, cconv_b).reshape(bs, s, g, n).transpose(1, 2)
    dt = F.softplus(mm(h, wdt, prec) + dt_bias)
    xh = xi.reshape(bs, s, nh, hp).transpose(1, 2)
    y = gq(ssd(fq(xh, prec), dt.transpose(1, 2), -torch.exp(a_log), fq(b, prec),
               fq(c, prec)), prec)
    y = y + xh * dskip[None, :, None, None]
    y = y.transpose(1, 2).reshape(bs, s, nh * hp) * F.silu(z)
    yg = y.reshape(bs, s, g, -1)
    y = (yg * torch.rsqrt(torch.mean(yg * yg, -1, keepdim=True) + eps)).reshape(y.shape)
    return x + mm(y * norm_g, wo, prec)


def _relu2_mlp(h, w1, w2, prec: Prec):
    return mm(torch.square(F.relu(mm(h, w1, prec))), w2, prec)


def _moe(cfg: Dict, prec: Prec, x, ln1, router, e_bias, w1, w2, shared_w1, shared_w2):
    bs, s, d = x.shape
    k, first = cfg["moe_topk"], cfg["moe_held_first"]
    h = rms_norm(x, ln1, cfg["norm_eps"]).reshape(bs * s, d)
    scores = torch.sigmoid(mm(h, router, prec))
    choice = (scores + e_bias).detach()
    experts = torch.sort(choice, dim=-1, descending=True, stable=True).indices[:, :k]
    gates = scores.gather(-1, experts)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20) * cfg["moe_scale"]
    out = torch.zeros_like(h)
    for j in range(w1.shape[0]):
        rows, slot = torch.nonzero(experts == first + j, as_tuple=True)
        if rows.numel():
            ye = _relu2_mlp(h[rows], w1[j], w2[j], prec)
            out = out.index_add(0, rows, ye * gates[rows, slot, None])
    y = out + _relu2_mlp(h, shared_w1, shared_w2, prec)
    return x + y.reshape(bs, s, d) + 0.0 * e_bias.sum()


def _attn(cfg: Dict, prec: Prec, x, ln1, wq, wk, wv, wo):
    b, s, _ = x.shape
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    h = rms_norm(x, ln1, cfg["norm_eps"])
    q = mm(h, wq, prec).reshape(b, s, hq, hd).transpose(1, 2)
    k = mm(h, wk, prec).reshape(b, s, hkv, hd).transpose(1, 2)
    v = mm(h, wv, prec).reshape(b, s, hkv, hd).transpose(1, 2)
    o = attention(q, k, v, prec)
    return x + mm(o.transpose(1, 2).reshape(b, s, hq * hd), wo, prec)


BLOCKS = {"mamba": _mamba, "moe": _moe, "attn": _attn}


def loss(p: Dict[str, torch.Tensor], cfg: Dict, batch: Dict[str, torch.Tensor],
         prec: Prec) -> torch.Tensor:
    labels = batch["labels"].long()
    b, s = labels.shape
    x = batch["embeddings"].float()
    seen: Dict[str, int] = {}
    for mark in cfg["layer_pattern"]:
        kind = KINDS[mark]
        i = seen.get(kind, 0)
        seen[kind] = i + 1
        block = functools.partial(BLOCKS[kind], cfg, prec)
        x = checkpointed(block, x, *(p[f"layers.{i}.{kind}.{k}"] for k in KEYS[kind]))
    h = rms_norm(x, p["final_norm"], cfg["norm_eps"])
    return cross_entropy(h.reshape(b * s, -1), p["unembed"], labels.reshape(-1), prec)
