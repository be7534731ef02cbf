"""``ssd_grouped_fwd_roofline``: the SSD scan kernel's share of its
roofline, in %, where B and C come per group of heads (a layer-pattern
model's Mamba layers: G = batch x ``ssm_groups`` rows of B and C, B·H
heads of ``ssm_nheads``).  The closed forms are ``ssd_fwd_roofline``'s,
imported: the least work of the chunked algorithm at its cheapest chunk,
the least traffic reading x, dt, a, B and C once and writing y once.
Kernels: ``ssd_split_bc``, ``ssd_chunk_vec`` and ``ssd_wgmma``."""

from ._kernels import SSD_FWD, Reading, roofline_pct
from .ssd_fwd_roofline import flop, moved


def shape(r: Reading):
    """(B·H heads, G rows of B and C, S, P, N)."""
    m, t = r.model, r.traffic
    b = t["batch"]
    return (b * m["ssm_nheads"], b * m["ssm_groups"], t["seq_len"], m["ssm_headdim"],
            m["ssm_state"])


def read(r: Reading):
    if not r.model.get("ssm_nheads"):
        return None
    bh, g, s, p, n = shape(r)
    return roofline_pct(r, SSD_FWD, flop(bh, s, p, n), moved(bh, g, s, p, n))
