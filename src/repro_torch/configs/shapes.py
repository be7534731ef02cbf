"""Assigned input-shape set (4 shapes × 10 archs = 40 dry-run cells)."""

from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.models.config import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "shapes_for"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode | long_decode

    @property
    def lowers(self) -> str:
        return "train_step" if self.kind == "train" else (
            "prefill" if self.kind == "prefill" else "serve_step")


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "long_decode"),
}


def shapes_for(cfg: ModelConfig) -> List[ShapeSpec]:
    """long_500k needs sub-quadratic sequence mixing: SSM/hybrid only (the 8
    pure-full-attention archs skip it — DESIGN.md §Arch-applicability)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.family in ("ssm", "hybrid"):
        out.append(SHAPES["long_500k"])
    return out
