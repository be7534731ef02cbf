"""``mamba_glue_roofline``: the Mamba-2 mixer's glue kernels' share of
their bytes bound, in %, over a layer-pattern model's Mamba layers.

A Mamba layer launches, in each of its forward passes (the forward and
remat's recompute), the conv and SiLU of x, of B and of C
(``mamba_conv_silu_fwd``, with the conv's bias) and the skip, gate and
grouped norm (``mamba_gate_norm_fwd``), and in the backward each one's
gradient (``mamba_conv_silu_bwd``, ``mamba_gate_norm_bwd``, and the
column sums ``mamba_glue_colsum``).  The least traffic of each reads every
input once and writes every output once: activations in the model's dtype,
the conv's taps and bias, D, the norm's gain and the rows' rsqrt in
float32.  The share is the step's least time at the card's bandwidth over
the glue kernels' device time a step."""

from __future__ import annotations

import re
from typing import Dict

from portbench.peaks import least_seconds

from ._kernels import Reading, group

#: the glue's kernels, their gradients' column sums included
GLUE = re.compile(r"\bmamba_(conv_silu_fwd|conv_silu_bwd|gate_norm_fwd|gate_norm_bwd|"
                  r"glue_colsum)\b")


def _conv(rows: int, ch: int, k: int, item: int, bias: bool) -> Dict[str, int]:
    n, wb = rows * ch, ch * (k + bias) * 4
    return {"fwd": 2 * n * item + wb, "bwd": 3 * n * item + 2 * wb}


def _norm(rows: int, di: int, heads: int, groups: int, item: int) -> Dict[str, int]:
    n, small = rows * di, (heads + di) * 4
    return {"fwd": 4 * n * item + small + rows * groups * 4,
            "bwd": 7 * n * item + 2 * small + rows * groups * 4}


def layer_bytes(m: Dict, t: Dict) -> int:
    """The least bytes one Mamba layer's glue moves in a remat step: two
    forwards and one gradient of each of its kernels."""
    rows = t["batch"] * t["seq_len"]
    item = 2 if m.get("dtype", "bfloat16") == "bfloat16" else 4
    heads, g = m["ssm_nheads"], m["ssm_groups"]
    di, gn, k, bias = heads * m["ssm_headdim"], g * m["ssm_state"], m["ssm_conv"], \
        bool(m.get("ssm_conv_bc"))
    parts = [_conv(rows, di, k, item, bias), _norm(rows, di, heads, g, item)]
    if m.get("ssm_conv_bc"):
        parts += [_conv(rows, gn, k, item, bias)] * 2
    return sum(2 * p["fwd"] + p["bwd"] for p in parts)


def read(r: Reading):
    m = r.model
    if r.steps <= 0 or "M" not in m.get("layer_pattern", ""):
        return None
    sec, calls = group(r, GLUE)
    if not calls or sec <= 0:
        return None
    moved = m["layer_pattern"].count("M") * layer_bytes(m, r.traffic)
    return 100.0 * r.steps * least_seconds(0.0, moved) / sec
