"""hymba-1.5b [hybrid] — 32L d1600 25H(kv5) ff5504 v32001 ssm_state=16;
parallel attention + mamba heads.  [arXiv:2411.13676; hf]"""
from repro_torch.models.config import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001, ssm_state=16, ssm_headdim=64, ssm_expand=2,
    sliding_window=1024, rope_theta=1e4,
))
