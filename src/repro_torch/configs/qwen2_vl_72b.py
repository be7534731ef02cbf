"""qwen2-vl-72b [vlm] — 80L d8192 64H(kv8) ff29568 v152064, M-RoPE, dynamic
resolution.  Vision frontend is a STUB per assignment: input_specs() provides
precomputed patch embeddings + 3-component positions.  [arXiv:2409.12191; hf]"""
from repro_torch.models.config import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064, mrope=True, mrope_sections=(16, 24, 24),
    frontend="embeddings", rope_theta=1e6,
))
