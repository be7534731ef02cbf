"""``train_mfu``: the step's useful work over the card's bf16 peak, in %.

Useful FLOP a token: 6·N (forward and backward through every matrix that
multiplies activations: the blocks' and the unembedding, not the
embedding table, which is a lookup), plus causal attention's 6·L·H·D·S
(QK^T and PV over the S/2 keys a query sees on average, forward and
backward).  Remat's recomputation is not useful work and is not counted;
nor is the SSD scan's own work (mamba2's state products, under 2 % of its
6·N).  The count depends on the shapes alone, so the share stays at or
under 100 % whatever implements the step.  Time per step: the window on
the host's clock over the steps completed in it.
"""

from __future__ import annotations

from typing import Dict

from portbench.peaks import BF16_FLOPS

from ._kernels import Reading


def matrix_params(m: Dict) -> int:
    """N: the parameters of the matrices that multiply activations."""
    d, v, layers = m["d_model"], m["vocab"], m["n_layers"]
    if m["family"] == "dense":
        hq, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        per_layer = 2 * d * hq * hd + 2 * d * hkv * hd + 3 * d * m["d_ff"]
    elif m["family"] == "ssm":
        di = d * m["ssm_expand"]
        heads = di // m["ssm_headdim"]
        # wz, wx, wb, wc, wdt in; the depthwise conv; wo out
        per_layer = d * (2 * di + 2 * m["ssm_state"] + heads) + di * m["ssm_conv"] + di * d
    else:
        raise ValueError(f"train_mfu counts dense and ssm models, not {m['family']!r}")
    return layers * per_layer + d * v


def attention_flop_per_token(m: Dict, seq_len: int) -> float:
    if m["family"] != "dense":
        return 0.0
    return 6.0 * m["n_layers"] * m["n_heads"] * m["head_dim"] * seq_len


def flop_per_token(m: Dict, seq_len: int) -> float:
    return 6.0 * matrix_params(m) + attention_flop_per_token(m, seq_len)


def read(r: Reading):
    if r.steps <= 0:
        return None
    t = r.traffic
    flop = t["batch"] * t["seq_len"] * flop_per_token(r.model, t["seq_len"])
    return 100.0 * flop / (BF16_FLOPS * r.window_s / r.steps)
