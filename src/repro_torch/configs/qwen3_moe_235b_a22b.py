"""qwen3-moe-235b-a22b [moe] — 94L d4096 64H(kv4) expert_ff1536 v151936,
128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B family; hf]"""
from repro_torch.models.config import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, moe_experts=128, moe_topk=8,
    rope_theta=1e6,
))
