"""Architecture registry: full configs (dry-run) + smoke variants (CPU tests)."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.config import ModelConfig

__all__ = ["register", "get_config", "get_smoke", "ARCHS", "smoke_variant"]

ARCHS: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return ARCHS[name]


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: 2 layers, narrow widths, tiny tables."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        remat="none",
    )
    if cfg.is_moe:
        kw.update(moe_experts=8, moe_topk=2)
    if cfg.has_ssm:
        kw.update(ssm_state=16, ssm_headdim=32, ssm_expand=2)
    if cfg.sliding_window:
        kw.update(sliding_window=64)
    if cfg.mrope:
        kw.update(mrope_sections=(4, 6, 6))   # scaled to the reduced head_dim
    return dataclasses.replace(cfg, **kw)


def get_smoke(name: str) -> ModelConfig:
    return smoke_variant(get_config(name))


def _ensure_loaded():
    if not ARCHS:
        from . import (kimi_k2_1t_a32b, llama3_2_1b, mamba2_780m,  # noqa: F401
                       minicpm_2b, minitron_8b, mistral_nemo_12b, musicgen_large,
                       hymba_1_5b, qwen2_vl_72b, qwen3_moe_235b_a22b)


def all_arch_names():
    _ensure_loaded()
    return sorted(ARCHS.keys())
