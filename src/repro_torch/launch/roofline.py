"""Roofline terms of a dry-run cell, and the hardware dicts they price with.

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = bytes_per_device / HBM_bw
    collective term = collective_bytes_per_device / link_bw

The port's copy of the JAX package's ``launch/roofline.py``.  The module is
framework-free: ``collective_bytes`` reads HLO text (the reference's
parser, kept so that a record the JAX package compiled can be read here),
``structural_memory_bytes`` and ``model_flops`` are closed forms of the
config and the shape, and ``derive_terms`` turns a cell's counts into the
three terms.  The port's dry-run (``launch/dryrun.py``) feeds it counts
made on meta tensors and a collective model derived from the sharding plan.

Two hardware dicts:

- ``TPU_V5E``: a TPU v5e chip's published peaks, the reference's pricing
  dict.  The dry-run's records and the comm domain's analytic fabric model
  (``comm/dse_comm.py``) price with it, so the port's numbers compare with
  the reference's; they are not numbers of the card the port runs on.
- ``H100_SXM``: the NVIDIA H100 SXM's published peaks, with which the same
  terms price a step on that card.

One reference defect is not copied: its ``roofline_fraction`` divides by
``TPU_V5E``'s peak whatever dict the terms were derived with.  The port's
terms carry the peak they were derived with; under ``TPU_V5E`` every field
is the reference's.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

TPU_V5E = {
    "peak_flops_bf16": 197e12,   # per chip
    "hbm_gbps": 819e9,           # bytes/s
    "ici_link_gbps": 50e9,       # bytes/s per link
}

H100_SXM = {
    # NVIDIA H100 Tensor Core GPU data sheet, SXM part: 989.4 TFLOP/s
    # dense bf16 on the tensor cores (1,979 with sparsity), at 700 W
    "peak_flops_bf16": 989.4e12,
    # the same data sheet: 3.35 TB/s of HBM3 bandwidth
    "hbm_gbps": 3.35e12,
    # the same data sheet: NVLink 900 GB/s per GPU, both directions summed
    # over its 18 links; 450 GB/s each way (under the key derive_terms reads)
    "ici_link_gbps": 450e9,
}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(text: str) -> int:
    """Sum bytes of every dtype[shape] token in a result-type string."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, Dict[str, float]]:
    """Per-collective-kind {count, bytes} from (lowered or compiled) HLO text."""
    stats = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        line = line.strip()
        if "=" not in line:
            continue
        _, _, rhs = line.partition("=")
        body = rhs.strip()
        for kind in _COLLECTIVES:
            # match the opcode, not tuple-element accessors like get-tuple-element
            if re.search(rf"\b{kind}(-start|-done)?\(", body):
                if kind + "-done(" in body:
                    continue  # bytes counted at -start
                # result type string = text before the opcode
                restype = body.split(kind)[0]
                stats[kind]["count"] += 1
                stats[kind]["bytes"] += _shape_bytes(restype)
                break
    return stats


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_per_device: float = 0.0
    #: the bf16 peak the terms were derived with (not in ``as_dict``)
    peak_flops: float = TPU_V5E["peak_flops_bf16"]

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        if self.flops_per_device <= 0:
            return 0.0
        return self.model_flops_per_device / self.flops_per_device

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step ran at its
        bound: useful model FLOPs / (peak × bound-time)."""
        if self.bound_s <= 0:
            return 0.0
        return self.model_flops_per_device / (self.peak_flops * self.bound_s)

    def as_dict(self):
        d = dataclasses.asdict(self)
        del d["peak_flops"]
        return {**d,
                "bound_s": self.bound_s,
                "useful_flops_ratio": self.useful_flops_ratio,
                "roofline_fraction": self.roofline_fraction}


def structural_memory_bytes(cfg, shape, mesh_shape: Dict[str, int],
                            opt_name: str = "adamw") -> float:
    """Analytic per-device HBM traffic estimate for one step.

    The unfused ``bytes accessed`` count (every operation's operands and
    results; ~10-20× real fused HBM traffic) is recorded only as an upper
    bound; the memory roofline term uses this structural model instead.
    Conventions:
      * weights: fwd read + remat re-read + bwd read (bf16) and, for train,
        fp32 grad write+read plus optimizer state read+write,
      * activations: residual-stream in/out per layer ×2 passes + internal
        working tensors of attention/MLP/MoE at their sharded widths,
      * vocab head: logits write + CE read + bwd read at the sharded vocab,
      * decode: all local weights once + full KV-cache/SSM-state read.
    """
    n_chips = 1
    for v in mesh_shape.values():
        n_chips *= v
    tp = mesh_shape.get("model", 1)
    dp = n_chips // tp
    n_params_local = cfg.param_count() / n_chips
    A = 2  # bf16 activation bytes
    d = cfg.d_model
    vocab_shard = cfg.vocab / tp

    if shape.kind in ("train", "prefill"):
        tokens_local = shape.seq_len * shape.global_batch / dp
    else:
        tokens_local = max(shape.global_batch / dp, 1)

    # ---- weights
    if shape.kind == "train":
        per_param = 2 + 2 + 2 + 4 + 4          # fwd, remat, bwd reads + grad w/r
        per_param += {"adamw": 20, "adafactor": 8}.get(opt_name, 20)
    else:
        per_param = 2                           # single fwd read
    weight_bytes = n_params_local * per_param

    # ---- per-layer activations
    passes = 3 if shape.kind == "train" else 1  # fwd, remat-fwd, bwd
    resid = 4 * tokens_local * d * A            # read+write per pass boundary
    internal = 0.0
    if cfg.has_attention:
        heads_w = cfg.n_heads * cfg.hd / tp
        internal += 6 * tokens_local * heads_w * A       # q,o + scores blocks
        internal += 4 * tokens_local * (cfg.n_kv_heads * cfg.hd) * A
        if shape.kind == "prefill" and shape.seq_len >= 8192:
            # blockwise attention re-reads local KV once per q block
            nq = shape.seq_len / 2048
            internal += nq * tokens_local * (cfg.n_kv_heads * cfg.hd) * A * 0.25
    if cfg.has_ssm:
        internal += 8 * tokens_local * (cfg.ssm_inner / tp) * A
        internal += 2 * tokens_local * cfg.ssm_state * A
    if cfg.is_moe:
        ff_w = cfg.d_ff  # expert ff (local expert count × ff / experts ≈ ff per token-slot)
        internal += 2 * cfg.moe_topk * cfg.capacity_factor * tokens_local * d * A * 4
        internal += 2 * cfg.moe_topk * tokens_local * ff_w * A
    elif cfg.d_ff:
        internal += 6 * tokens_local * (cfg.d_ff / tp) * A
    act_bytes = cfg.n_layers * passes * (resid + internal) / 2  # /2: fusion of elementwise pairs

    # ---- vocab head
    head_passes = 10 if shape.kind == "train" else 2
    head_bytes = tokens_local * vocab_shard * head_passes

    # ---- decode state traffic
    state_bytes = 0.0
    if shape.kind in ("decode", "long_decode"):
        b_local = max(shape.global_batch / dp, 1)
        if cfg.has_attention:
            cache_len = min(cfg.sliding_window or shape.seq_len, shape.seq_len) / tp
            state_bytes += cfg.n_layers * b_local * cfg.n_kv_heads * cfg.hd * cache_len * A * 2
        if cfg.has_ssm:
            state_bytes += (cfg.n_layers * b_local * cfg.ssm_heads * cfg.ssm_headdim
                            * cfg.ssm_state * 4 * 2)
    return float(weight_bytes + act_bytes + head_bytes + state_bytes)


def derive_terms(cost: Dict, coll_stats: Dict, *, model_flops_global: float,
                 n_chips: int, memory_bytes: Optional[float] = None,
                 hw: Dict = TPU_V5E) -> RooflineTerms:
    flops = float(cost.get("flops", 0.0))
    byts = float(memory_bytes if memory_bytes is not None
                 else cost.get("bytes accessed", 0.0))
    cbytes = float(sum(v["bytes"] for v in coll_stats.values()))
    compute_s = flops / hw["peak_flops_bf16"]
    memory_s = byts / hw["hbm_gbps"]
    coll_s = cbytes / hw["ici_link_gbps"]
    dom = max((("compute", compute_s), ("memory", memory_s), ("collective", coll_s)),
              key=lambda kv: kv[1])[0]
    return RooflineTerms(
        flops_per_device=flops, bytes_per_device=byts,
        collective_bytes_per_device=cbytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dom, model_flops_per_device=model_flops_global / n_chips,
        peak_flops=hw["peak_flops_bf16"])


def model_flops(cfg, shape) -> float:
    """Useful-work convention: 6·N·D train (3 passes), 2·N·D fwd-only; MoE
    uses N_active.  D = tokens processed by the step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
