from .ops import conv_silu_heads, skip_gate_norm
from .ref import (conv_silu_heads_bwd_ref, conv_silu_heads_ref, skip_gate_norm_bwd_ref,
                  skip_gate_norm_ref)

__all__ = ["conv_silu_heads", "conv_silu_heads_bwd_ref", "conv_silu_heads_ref",
           "skip_gate_norm", "skip_gate_norm_bwd_ref", "skip_gate_norm_ref"]
