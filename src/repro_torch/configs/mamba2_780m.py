"""mamba2-780m [ssm] — 48L d1536 attn-free v50280 ssm_state=128 (SSD).
[arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab=50280, ssm_state=128, ssm_headdim=64, ssm_expand=2,
))
