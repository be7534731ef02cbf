"""minitron-8b [dense] — 32L d4096 32H(kv8) ff16384 v256000 (pruned
nemotron).  [arXiv:2407.14679; hf]"""
from repro_torch.models.config import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=256000, rope_theta=1e6,
))
