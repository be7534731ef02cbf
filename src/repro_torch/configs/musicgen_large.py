"""musicgen-large [audio] — 48L d2048 32H(kv32) ff8192 v2048, decoder-only
over EnCodec tokens.  EnCodec frontend is a STUB per assignment:
input_specs() provides precomputed frame embeddings.  [arXiv:2306.05284; hf]"""
from repro_torch.models.config import ModelConfig
from .registry import register

CONFIG = register(ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, frontend="embeddings", rope_theta=1e4,
))
