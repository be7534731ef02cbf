"""Model configuration + sharding plan datatypes for all 10 architectures.

The port's copy of the JAX package's ``models/config.py``; only
``activation_dtype`` differs, naming a ``torch.dtype``.  ``ShardingPlan``
names mesh axes as in the reference; the port runs on one device, where
every axis has extent 1 (a larger extent raises where a mesh is passed).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ModelConfig", "ShardingPlan", "SINGLE_POD_PLAN", "MULTI_POD_PLAN"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- MoE (the switch-fabric layer) ---
    moe_experts: int = 0
    moe_topk: int = 0
    capacity_factor: float = 1.25  # VOQ depth sizing — DSE-tunable
    router: str = "learned_topk"   # FullLookup analogue | "hash" (MultiBankHash)
    # --- SSM ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # --- attention ---
    rope_theta: float = 1e6
    mrope: bool = False                      # qwen2-vl M-RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    sliding_window: int = 0                  # hybrid long-context attention
    attn_impl: str = "auto"                  # plain | blockwise | auto
    # --- IO frontend ---
    frontend: str = "tokens"                 # tokens | embeddings (vlm/audio stub)
    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    remat: str = "block"                     # none | block — activation ckpt policy
    # --- lowering/measurement knobs (dry-run cost variant) ---
    scan_layers: bool = True                 # False: unroll (exact cost_analysis)
    attn_unroll: bool = False                # fully unroll blockwise-attn scans

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def ssm_heads(self) -> int:
        return (self.d_model * self.ssm_expand) // self.ssm_headdim

    @property
    def ssm_inner(self) -> int:
        return self.d_model * self.ssm_expand

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    # ------------------------------------------------------- parameter counts
    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab
        per_layer = 0
        if self.has_attention:
            hq, hkv, hd = self.n_heads, self.n_kv_heads, self.hd
            per_layer += d * hq * hd + 2 * d * hkv * hd + hq * hd * d
        if self.has_ssm:
            di, n, hs = self.ssm_inner, self.ssm_state, self.ssm_heads
            # wz + wx + wb + wc + wdt + conv + norm_g + wo (+ per-head scalars)
            per_layer += d * (2 * di + 2 * n + hs) + di * (self.ssm_conv + 1) + di * d + 3 * hs
        if self.is_moe:
            per_layer += self.moe_experts * (3 * d * ff) + d * self.moe_experts
        elif ff:
            per_layer += 3 * d * ff                      # gated MLP
        per_layer += 2 * d                               # norms
        return self.n_layers * per_layer + 2 * v * d     # embed + unembed

    def active_param_count(self) -> int:
        """6·N_active·D convention for MoE roofline accounting."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        per_layer_moe_active = self.moe_topk * (3 * d * ff) + d * self.moe_experts
        per_layer_moe_total = self.moe_experts * (3 * d * ff) + d * self.moe_experts
        return self.param_count() - self.n_layers * (per_layer_moe_total - per_layer_moe_active)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Named-axis parallelism plan; axis names must exist in the mesh."""

    dp_axes: Tuple[str, ...] = ("data",)      # batch-sharding axes
    tp_axis: str = "model"                    # tensor/expert parallel axis
    fsdp_axes: Tuple[str, ...] = ("data",)    # ZeRO-3 weight-sharding axes (⊆ dp)
    fsdp_weights: bool = True
    tensor_parallel: bool = True              # False: pure DP/FSDP (small dense
                                              # models over-shard at TP=16)
    sp_activations: bool = False              # sequence-parallel residual stream
    shard_kv_seq_decode: bool = True          # decode KV cache seq-sharded on tp
    embed_dmodel_sharded: bool = False        # shard embed on d (local gather)
                                              # instead of vocab (replicating
                                              # gather under GSPMD)

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return tuple(self.dp_axes) + (self.tp_axis,)

    @property
    def tp(self):
        """Tensor axis for parameter specs (None disables TP sharding)."""
        return self.tp_axis if self.tensor_parallel else None


#: single pod: batch+FSDP over "data", TP over "model"
SINGLE_POD_PLAN = ShardingPlan(dp_axes=("data",), fsdp_axes=("data",))
#: multi-pod: batch over ("pod","data"), FSDP within pod ("data"), pure DP
#: across pods — the cross-pod gradient all-reduce is where the compressed
#: gradient protocol (int8 payload) applies.
MULTI_POD_PLAN = ShardingPlan(dp_axes=("pod", "data"), fsdp_axes=("data",))
