"""``hybrid_moe_train_mfu``: a layer-pattern model's training step's useful
work over the card's bf16 peak, in %, for a cell whose device holds some of
each MoE layer's experts (Nemotron-H's stage: M, E and * layers).

Useful FLOP a token: 6·N_active, N_active the parameters of the matrices
that multiply activations for one token: the Mamba-2 layers' input
projections (z, x, B and C of every group, dt), depthwise convs (x, B, C)
and output projection; the attention layers' four projections; the MoE
layers' router over all experts, the shared expert, and the held experts
at the pairs routed to them on average (top-k · held / experts of a
token's k choices, each an expert's two matrices); the unembedding.  Plus
causal attention's 6·L_attn·H·D·S (QK^T and PV over the S/2 keys a query
sees on average, forward and backward).  Remat's recomputation and the SSD
scan's own state products are not counted.  Shapes alone decide it, so the
share stays at or under 100 % whatever implements the step.  Time per
step: the window on the host's clock over the steps completed in it.
"""

from __future__ import annotations

from typing import Dict

from portbench.peaks import BF16_FLOPS

from ._kernels import Reading


def layer_params(m: Dict) -> Dict[str, float]:
    """Active matrix parameters a token, by layer kind."""
    d = m["d_model"]
    di = m["ssm_nheads"] * m["ssm_headdim"]
    gn = m["ssm_groups"] * m["ssm_state"]
    conv = di + (2 * gn if m.get("ssm_conv_bc") else 0)
    held = m.get("moe_held") or m["moe_experts"]
    pairs = m["moe_topk"] * held / m["moe_experts"]
    return {"M": d * (2 * di + 2 * gn + m["ssm_nheads"]) + conv * m["ssm_conv"] + di * d,
            "*": 2 * d * m["n_heads"] * m["head_dim"] + 2 * d * m["n_kv_heads"] * m["head_dim"],
            "E": d * m["moe_experts"] + 2 * d * m.get("moe_shared_ff", 0)
            + pairs * 2 * d * m["d_ff"]}


def flop_per_token(m: Dict, seq_len: int) -> float:
    per = layer_params(m)
    pattern = m["layer_pattern"]
    n = sum(per[c] for c in pattern) + m["d_model"] * m["vocab"]
    attn = 6.0 * pattern.count("*") * m["n_heads"] * m["head_dim"] * seq_len
    return 6.0 * n + attn


def read(r: Reading):
    if r.steps <= 0 or not r.model.get("layer_pattern"):
        return None
    t = r.traffic
    flop = t["batch"] * t["seq_len"] * flop_per_token(r.model, t["seq_len"])
    return 100.0 * flop / (BF16_FLOPS * r.window_s / r.steps)
