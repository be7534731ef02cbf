"""``ssd_fwd_roofline``: the SSD scan kernel's share of its roofline, in %.

One call over a step's B·H heads of S steps, head size P, state N, B and C
one row per sequence (bf16), x and y bf16, dt float32 [B·H, S], a float32
[B·H].  The least work of one head is that of the chunked algorithm at its
cheapest chunk length c (C·B^T, the masked product with x, the
inter-chunk product and the state update, 2·c·(c·N + c·P + 2·P·N) a
chunk, plus P·N to decay the state; c = 1 is the plain recurrence); the
least traffic reads x, dt, a, B and C once and writes y once.  Kernels:
``ssd_split_bc``, ``ssd_chunk_vec`` and ``ssd_wgmma``."""

from ._kernels import SSD_FWD, Reading, roofline_pct


def head_flop(s: int, p: int, n: int) -> int:
    return min(-(-s // c) * (2 * c * (c * n + c * p + 2 * p * n) + p * n)
               for c in range(1, min(s, 256) + 1))


def shape(r: Reading):
    m, t = r.model, r.traffic
    heads = m["d_model"] * m["ssm_expand"] // m["ssm_headdim"]
    b = t["batch"]
    return b * heads, b, t["seq_len"], m["ssm_headdim"], m["ssm_state"]


def flop(bh, s, p, n) -> float:
    return bh * head_flop(s, p, n)


def moved(bh, g, s, p, n) -> float:
    return 2 * 2 * bh * s * p + 4 * bh * s + 4 * bh + 2 * 2 * g * s * n


def read(r: Reading):
    if r.model["family"] != "ssm":
        return None
    bh, g, s, p, n = shape(r)
    return roofline_pct(r, SSD_FWD, flop(bh, s, p, n), moved(bh, g, s, p, n))
