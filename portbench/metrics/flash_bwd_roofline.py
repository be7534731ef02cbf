"""``flash_bwd_roofline``: the attention gradient kernel's share of its
roofline, in %.

One call at the forward's shapes: the least work any implementation
needs is dV = P^T dO, dP = dO V^T, dQ = dS K and dK = dS^T Q over the
causal pairs, twice the forward's products, with no recomputation of the
scores; the least traffic reads q, k, v, o, dO (bf16) and the log-sum-exp
(float32) once and writes dq, dk, dv (bf16) once.  Kernels: ``bwd_pre``,
``bwd_kv``, ``bwd_q`` and their ``_wgmma`` forms."""

from ._kernels import FLASH_BWD, Reading, roofline_pct
from .flash_fwd_roofline import pairs, shape


def flop(b, hq, s, d) -> float:
    return 4 * 2 * b * hq * pairs(s) * d


def moved(b, hq, hkv, s, d) -> float:
    return 2 * (3 * b * hq * s * d + 2 * b * hkv * s * d) + 4 * b * hq * s \
        + 2 * (b * hq * s * d + 2 * b * hkv * s * d)


def read(r: Reading):
    if r.model["family"] != "dense":
        return None
    b, hq, hkv, s, d = shape(r)
    return roofline_pct(r, FLASH_BWD, flop(b, hq, s, d), moved(b, hq, hkv, s, d))
