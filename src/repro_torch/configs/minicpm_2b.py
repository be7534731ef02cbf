"""minicpm-2b [dense] — 40L d2304 36H(kv36 ≡ MHA) ff5760 v122753 (WSD
schedule, llama-like arch).  [arXiv:2404.06395; hf]"""
from repro_torch.models.config import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
    d_ff=5760, vocab=122753, rope_theta=1e4,
))
