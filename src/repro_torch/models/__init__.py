"""The port's model layers: so far the configuration types and the MoE
layer (the dispatch fabric the comm domain tunes); attention, Mamba-2 and
the transformer come with the model forward path (ROADMAP, slice 4)."""
from .config import MULTI_POD_PLAN, SINGLE_POD_PLAN, ModelConfig, ShardingPlan
from .moe import MoEOptions

__all__ = ["MULTI_POD_PLAN", "ModelConfig", "MoEOptions", "SINGLE_POD_PLAN",
           "ShardingPlan"]
