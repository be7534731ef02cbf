"""llama3.2-1b [dense] — 16L d2048 32H(kv8) ff8192 v128256.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.models.config import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=128256, rope_theta=5e5,
))
