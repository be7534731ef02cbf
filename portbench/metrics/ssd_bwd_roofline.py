"""``ssd_bwd_roofline``: the SSD scan's gradient kernel's share of its
roofline, in %.

One call at the forward's shapes: the least work is twice the forward's
(each product's two operand gradients); the least traffic reads x, dy, B,
C (bf16), dt and a (float32) once and writes dx, dB, dC (bf16), d(dt)
and da (float32) once.  Kernels: every ``ssd_bwd_*`` launch."""

from ._kernels import SSD_BWD, Reading, roofline_pct
from .ssd_fwd_roofline import head_flop, shape


def flop(bh, s, p, n) -> float:
    return 2 * bh * head_flop(s, p, n)


def moved(bh, g, s, p, n) -> float:
    return 2 * 3 * bh * s * p + 4 * 2 * bh * s + 4 * 2 * bh + 2 * 4 * g * s * n


def read(r: Reading):
    if r.model["family"] != "ssm":
        return None
    bh, g, s, p, n = shape(r)
    return roofline_pct(r, SSD_BWD, flop(bh, s, p, n), moved(bh, g, s, p, n))
