"""Deterministic synthetic data pipeline with exact-resume semantics."""
from .pipeline import DataConfig, SyntheticLM, make_batch_for_shape
__all__ = ["DataConfig", "SyntheticLM", "make_batch_for_shape"]
