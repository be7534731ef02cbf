"""kimi-k2-1t-a32b [moe] — 61L d7168 64H(kv8) expert_ff2048 v163840,
384 experts top-8 (trillion-param MoE).  [arXiv:2501.kimi2; unverified]"""
from repro_torch.models.config import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab=163840, moe_experts=384, moe_topk=8,
    rope_theta=5e6,
))
