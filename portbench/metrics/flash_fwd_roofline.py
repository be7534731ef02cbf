"""``flash_fwd_roofline``: the attention kernel's share of its roofline, in %.

One call, q [B, Hq, S, D] and k/v [B, Hkv, S, D] in bf16, causal: the
least work is QK^T and PV over the S(S+1)/2 pairs a causal mask keeps,
2 products x 2 FLOP x D each; the least traffic reads q, k and v once and
writes o (bf16) and the log-sum-exp (float32, one a row) once.  The least
time is the larger of the two at the card's peaks; the share is that over
the kernels' time (``flash_fwd`` and ``flash_wgmma``), summed over the
window's calls."""

from ._kernels import FLASH_FWD, Reading, roofline_pct


def shape(r: Reading):
    m, t = r.model, r.traffic
    return t["batch"], m["n_heads"], m["n_kv_heads"], t["seq_len"], m["head_dim"]


def pairs(s: int) -> int:
    return s * (s + 1) // 2


def flop(b, hq, s, d) -> float:
    return 2 * 2 * b * hq * pairs(s) * d


def moved(b, hq, hkv, s, d) -> float:
    return 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d) + 4 * b * hq * s


def read(r: Reading):
    if r.model["family"] != "dense":
        return None
    b, hq, hkv, s, d = shape(r)
    return roofline_pct(r, FLASH_FWD, flop(b, hq, s, d), moved(b, hq, hkv, s, d))
