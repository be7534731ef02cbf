"""``ssd_grouped_bwd_roofline``: the SSD scan's gradient kernel's share of
its roofline, in %, at ``ssd_grouped_fwd_roofline``'s grouped shapes, with
``ssd_bwd_roofline``'s closed forms, imported: twice the forward's least
work; the least traffic reading x, dy, B, C, dt and a once and writing dx,
dB, dC, d(dt) and da once.  Kernels: every ``ssd_bwd_*`` launch."""

from ._kernels import SSD_BWD, Reading, roofline_pct
from .ssd_bwd_roofline import flop, moved
from .ssd_grouped_fwd_roofline import shape


def read(r: Reading):
    if not r.model.get("ssm_nheads"):
        return None
    bh, g, s, p, n = shape(r)
    return roofline_pct(r, SSD_BWD, flop(bh, s, p, n), moved(bh, g, s, p, n))
