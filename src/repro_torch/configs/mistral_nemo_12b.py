"""mistral-nemo-12b [dense] — 40L d5120 32H(kv8) ff14336 v131072, 128k ctx.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.models.config import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, rope_theta=1e6,
))
