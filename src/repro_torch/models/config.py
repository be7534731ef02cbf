"""Model configuration + sharding plan datatypes for all 10 architectures.

The port's copy of the JAX package's ``models/config.py``; only
``activation_dtype`` differs, naming a ``torch.dtype``.  ``ShardingPlan``
names mesh axes as in the reference; the MoE layer shards over them when
given a ``launch.mesh.Mesh``, and the rest of the model runs on one device.
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
    # the dropless expert layer of a layer pattern's E (moe.apply_dropless:
    # a sigmoid router with a correction bias, the top-k normalised, relu²
    # experts, a shared expert); the capacity path above reads none of these
    moe_scale: float = 1.0         # routed scaling factor on the gates
    moe_shared_ff: int = 0         # width of the always-on shared expert
    moe_held_first: int = 0        # this device's experts: moe_held from the
    moe_held: int = 0              # first (0: all moe_experts)
    # --- SSM ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_nheads: int = 0            # SSM heads (0: d_model·ssm_expand / ssm_headdim)
    ssm_groups: int = 1            # groups of heads sharing B and C; the gated norm's groups
    ssm_conv_bc: bool = False      # the causal conv, with a bias, over B and C as well as x
    # --- attention ---
    rope_theta: float = 1e6
    mrope: bool = False                      # qwen2-vl M-RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    sliding_window: int = 0                  # hybrid long-context attention
    attn_impl: str = "auto"                  # plain | blockwise | auto
    use_rope: bool = True                    # False: no position encoding (NoPE)
    # --- layer pattern: one mixer a layer, M (Mamba-2), E (MoE) or *
    # (attention), each behind its own norm (Nemotron-H); "" -> the family's
    layer_pattern: str = ""
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
        return self.ssm_nheads or (self.d_model * self.ssm_expand) // self.ssm_headdim

    @property
    def ssm_inner(self) -> int:
        if self.ssm_nheads:
            return self.ssm_nheads * self.ssm_headdim
        return self.d_model * self.ssm_expand

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def moe_local(self) -> int:
        """The experts this device holds."""
        return self.moe_held or self.moe_experts

    @property
    def kinds(self) -> Tuple[str, ...]:
        """Each layer's mixer under ``layer_pattern``: mamba, moe or attn."""
        names = {"M": "mamba", "E": "moe", "*": "attn"}
        if len(self.layer_pattern) != self.n_layers or set(self.layer_pattern) - set(names):
            raise ValueError(f"layer_pattern {self.layer_pattern!r} must give one of "
                             f"M, E, * for each of {self.n_layers} layers")
        return tuple(names[c] for c in self.layer_pattern)

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
        if self.layer_pattern:
            return self._pattern_param_count(active=False)
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

    def _pattern_param_count(self, active: bool) -> int:
        """Parameters under ``layer_pattern`` (the experts this device holds;
        ``active``: the top-k of them a token uses)."""
        d, v = self.d_model, self.vocab
        hq, hkv, hd = self.n_heads, self.n_kv_heads, self.hd
        di, gn, hs, k = self.ssm_inner, self.ssm_groups * self.ssm_state, self.ssm_heads, \
            self.ssm_conv
        conv = di + (2 * gn if self.ssm_conv_bc else 0)
        per = {"mamba": d * (2 * di + 2 * gn + hs) + conv * (k + self.ssm_conv_bc)
               + di * (d + 1) + 3 * hs,
               "attn": d * hq * hd + 2 * d * hkv * hd + hq * hd * d,
               "moe": (min(self.moe_topk, self.moe_local) if active else self.moe_local)
               * 2 * d * self.d_ff + 2 * d * self.moe_shared_ff
               + (d + 1) * self.moe_experts}
        return sum(per[kind] + d for kind in self.kinds) + 2 * v * d

    def active_param_count(self) -> int:
        """6·N_active·D convention for MoE roofline accounting."""
        if self.layer_pattern:
            return self._pattern_param_count(active=True)
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
