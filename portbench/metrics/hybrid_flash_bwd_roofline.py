"""``hybrid_flash_bwd_roofline``: the attention gradient kernel's share of
its roofline, in %, in a layer-pattern model's attention layers, at
``hybrid_flash_fwd_roofline``'s shapes.  The closed forms are
``flash_bwd_roofline``'s, imported: twice the forward's products over the
causal pairs, no recomputation of the scores; q, k, v, o, dO and the
log-sum-exp read and dq, dk, dv written once.  Kernels: ``bwd_pre``,
``bwd_kv``, ``bwd_q`` and their ``_wgmma`` forms."""

from ._kernels import FLASH_BWD, Reading, roofline_pct
from .flash_bwd_roofline import flop, moved
from .flash_fwd_roofline import shape


def read(r: Reading):
    if "*" not in r.model.get("layer_pattern", ""):
        return None
    b, hq, hkv, s, d = shape(r)
    return roofline_pct(r, FLASH_BWD, flop(b, hq, s, d), moved(b, hq, hkv, s, d))
