"""Model zoo: config/plan datatypes, layers, attention, the MoE fabric,
Mamba-2, and the transformer's serving path (forward, prefill, decode) for
all 10 architectures.  Training (``loss_fn``, ``param_specs``) comes with a
later slice."""
from .config import MULTI_POD_PLAN, SINGLE_POD_PLAN, ModelConfig, ShardingPlan
from .moe import MoEOptions
from .transformer import (ModelBundle, decode_state_structs, decode_step, forward,
                          init_decode_state, init_params, prefill)

__all__ = ["MULTI_POD_PLAN", "ModelBundle", "ModelConfig", "MoEOptions",
           "SINGLE_POD_PLAN", "ShardingPlan", "decode_step", "forward",
           "init_decode_state", "init_params", "prefill", "decode_state_structs"]
