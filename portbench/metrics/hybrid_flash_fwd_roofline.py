"""``hybrid_flash_fwd_roofline``: the attention kernel's share of its
roofline, in %, in a layer-pattern model's attention layers (``*``: each a
causal call at q [B, Hq, S, D], k/v [B, Hkv, S, D] in bf16, run in the
forward and again in remat's recompute).  The closed forms are
``flash_fwd_roofline``'s, imported: QK^T and PV over the causal pairs; q,
k, v read and o and the log-sum-exp written once.  The calls are the
window's launches of ``flash_fwd`` or ``flash_wgmma``."""

from ._kernels import FLASH_FWD, Reading, roofline_pct
from .flash_fwd_roofline import flop, moved, shape


def read(r: Reading):
    if "*" not in r.model.get("layer_pattern", ""):
        return None
    b, hq, hkv, s, d = shape(r)
    return roofline_pct(r, FLASH_FWD, flop(b, hq, s, d), moved(b, hq, hkv, s, d))
