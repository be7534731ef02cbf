"""MoE layer as a SPAC switching fabric (DESIGN.md §2.2).

Token dispatch to experts *is* an input-queued crossbar, and this layer
implements it with the paper's architecture mapped 1:1:

  forward table   router: ``learned_topk`` (FullLookup: direct indexed one-hot
                  lookup) or ``hash`` (MultiBankHash: k LSH banks; bank
                  conflicts surface as capacity overflows)
  VOQ buffer      per-(shard, expert) capacity buffers [E, C, d]; C sized by
                  the capacity factor — the DSE's statistical buffer sizing
                  (queue-occupancy histogram @ drop rate ε) tunes it
  scheduler       the all-to-all schedule: "single" (one bulk exchange),
                  "chunked:K" (K pipelined exchanges that overlap expert
                  compute — the iSLIP/EDRRM analogue)
  protocol        dispatch payload dtype: bf16 or int8+scales (quant_pack),
                  cutting fabric bytes ~2×
  drops           tokens past capacity are dropped (combine contributes 0),
                  reported in aux — the packet-loss column of Table II

The port's copy of the JAX package's ``models/moe.py``, as plain functions
on tensors of one device.  The reference runs the layer inside
``shard_map`` over the runner's (1, 1) mesh, where every collective (the
all-to-alls, the all-gathers, ``psum``/``pmean``) is the identity; the port
runs the same arithmetic without them, and a mesh with an axis above 1
raises ``NotImplementedError`` (ROADMAP queue 1, item 3: mesh).  On one device
``weights="ff_sharded"`` computes what ``"gathered"`` does, as in the
reference on its (1, 1) mesh.

Where the numbers must match the reference's exactly (they decide the
token-drop rate and expert loads the DSE reports):

- top-k breaks ties by the lower index, as ``jax.lax.top_k`` does (a
  stable descending sort; ``torch.topk`` promises no order);
- the dispatch order is a stable argsort of the flattened expert ids;
- router logits are float32 products, so TF32 must be off on the card
  (``router_matmul`` raises otherwise);
- the hash router's uint32 arithmetic runs in int64 masked to 32 bits;
- ``drop_frac`` is ``1 - count(kept) * float32(1/n)`` in float32, as the
  reference's eager ``shard_map`` (the DSE's verify path) computes it.

The int8 payload goes through ``kernels.quant_pack`` (the hand-written CUDA
kernels on the card).  The expert FFN's bfloat16 products are
``torch.einsum`` (the reference leaves them to XLA), so ``y`` matches the
reference under a tolerance, not bitwise; the combine sums each token's k
contributions one bfloat16 add at a time in the reference's update order,
so ``y`` is the same from run to run on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import quant_pack
from .config import ModelConfig, ShardingPlan
from .layers import dense_init

__all__ = ["MoEOptions", "init_moe", "apply_moe", "top_k", "router_matmul",
           "check_single_device"]

_U32 = 0xFFFFFFFF
#: distinct odd multipliers of the hash router's k banks
_HASH_MULTS = (2654435761, 2246822519, 3266489917, 668265263,
               374761393, 2869860233, 3624381081, 961748927)


@dataclasses.dataclass(frozen=True)
class MoEOptions:
    """The DSE-tunable fabric knobs (CommSpec fragment)."""

    capacity_factor: float = 1.25
    payload: str = "bf16"          # bf16 | int8 — dispatch wire format
    a2a_chunks: int = 1            # 1 = "single"; >1 = pipelined chunks
    router: str = "learned_topk"   # learned_topk | hash
    weights: str = "gathered"      # gathered (FSDP all-gather at the boundary)
                                   # | ff_sharded (expert TP over the fsdp axis:
                                   #   zero weight comm — decode/serve path)

    @staticmethod
    def from_config(cfg: ModelConfig) -> "MoEOptions":
        return MoEOptions(capacity_factor=cfg.capacity_factor, router=cfg.router)


def check_single_device(mesh: Optional[Mapping[str, int]]) -> None:
    """``mesh`` is None (one device) or a mapping of axis name to extent;
    any extent above 1 is the multi-device fabric, not ported yet."""
    if mesh is None:
        return
    big = {ax: n for ax, n in dict(mesh).items() if n > 1}
    if big:
        raise NotImplementedError(
            f"mesh axes {big}: the multi-device MoE fabric (all-to-all over "
            "the tensor axis) is not ported to repro_torch yet (ROADMAP queue "
            "1, item 3: mesh); run on one device with mesh=None")


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             plan: Optional[ShardingPlan] = None) -> Dict[str, torch.Tensor]:
    """The layer's parameters, drawn from ``gen`` on its device: the float32
    router [d, E] and LSH projection [d, 32], and bfloat16 expert weights
    w1/wg [E, d, ff] and w2 [E, ff, d].  (The reference also returns
    partition specs; the port runs on one device and has none.)"""
    del plan
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    return {
        "router": dense_init(gen, (d, e), dtype=torch.float32),
        "hash_proj": torch.randn((d, 32), generator=gen, dtype=torch.float32,
                                 device=gen.device),
        "w1": dense_init(gen, (e, d, ff)),
        "wg": dense_init(gen, (e, d, ff)),
        "w2": dense_init(gen, (e, ff, d), fan_in=ff),
    }


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values by ascending index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 product that decides routing: on the card it must not run
    in TF32, which keeps ~3 decimal digits and moves experts at near-ties."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "router logits are float32 products and must not run in TF32; "
            "set torch.backends.cuda.matmul.allow_tf32 = False")
    return a @ b


def _route_learned(xs, router, topk):
    logits = router_matmul(xs.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = top_k(probs, topk)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    e = router.shape[-1]
    probs_mean = probs.mean(0)
    counts = torch.bincount(experts.reshape(-1), minlength=e).to(torch.float32)
    f = counts / counts.sum().clamp_min(1.0)
    aux = e * torch.sum(f * probs_mean)
    return experts, gates.to(xs.dtype), aux


def _route_hash(xs, hash_proj, topk, e):
    """MultiBankHash routing: k independent sign-LSH banks; conflicts appear
    as load imbalance -> capacity overflow (the paper's bank-conflict cost).
    The reference's uint32 arithmetic, in int64 masked to 32 bits."""
    proj = router_matmul(xs.to(torch.float32), hash_proj)
    bits = (proj > 0).to(torch.int64)
    weights = torch.arange(1, bits.shape[-1] + 1, dtype=torch.int64,
                           device=xs.device)
    folded = (bits * weights).sum(-1) & _U32
    mults = torch.tensor(_HASH_MULTS[:topk], dtype=torch.int64, device=xs.device)
    experts = ((((folded[:, None] + 1) * mults[None, :]) & _U32) >> 8) % e
    gates = torch.full(experts.shape, 1.0 / topk, dtype=xs.dtype,
                       device=xs.device)
    return experts, gates, torch.zeros((), dtype=torch.float32, device=xs.device)


def _expert_ffn(xin, w1, wg, w2):
    """[M, E_loc, c, d] -> [M, E_loc, c, d]: the gated FFN of each expert
    (in the promoted dtype of the tokens and the weights, as ``jnp.einsum``)."""
    dt = torch.promote_types(xin.dtype, w1.dtype)
    xin, w1, wg, w2 = xin.to(dt), w1.to(dt), wg.to(dt), w2.to(dt)
    h = torch.einsum("mecd,edf->mecf", xin, w1)
    g = torch.einsum("mecd,edf->mecf", xin, wg)
    h = h * torch.nn.functional.silu(g.to(torch.float32)).to(h.dtype)
    return torch.einsum("mecf,efd->mecd", h, w2)


def _wire(x: torch.Tensor, payload: str, dtype: torch.dtype) -> torch.Tensor:
    """One exchange over the fabric (the identity on one device); the int8
    payload is quantized before it and dequantized after it."""
    if payload != "int8":
        return x
    d = x.shape[-1]
    q, s = quant_pack.quantize(x.reshape(-1, d))
    return quant_pack.dequantize(q, s, dtype).reshape(x.shape)


def _fabric(xs, params, cfg: ModelConfig, opts: MoEOptions):
    """Dispatch → exchange → expert FFN → return on one device.  xs [T_m, d]."""
    t_m, d = xs.shape
    dev = xs.device
    e, k = cfg.moe_experts, cfg.moe_topk
    cap = max(int(np.ceil(t_m * k / e * opts.capacity_factor)), 1)

    if opts.router == "hash":
        experts, gates, aux = _route_hash(xs, params["hash_proj"], k, e)
    else:
        experts, gates, aux = _route_learned(xs, params["router"], k)

    # ---- VOQ pack: sort by expert, position-in-queue, drop past capacity
    e_flat = experts.reshape(-1)                                  # [T_m*k]
    g_flat = gates.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    es = e_flat[order]
    ts = order // k
    gs = g_flat[order]
    counts = torch.bincount(es, minlength=e)                      # queue occupancy
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(es.shape[0], device=dev) - starts[es]
    keep = pos < cap
    slot = torch.where(keep, es * cap + pos, torch.zeros_like(pos))
    # one token per kept slot; dropped entries add +0 to slot 0, as in the
    # reference (order-free: x + 0 == x), so the atomics on the card agree
    buf = torch.zeros((e * cap, d), dtype=xs.dtype, device=dev)
    buf.index_add_(0, slot, torch.where(keep[:, None], xs[ts],
                                        torch.zeros((), dtype=xs.dtype,
                                                    device=dev)))

    # ---- fabric exchange + expert compute, possibly in pipelined chunks
    n_chunks = max(1, min(opts.a2a_chunks, cap))
    c_sub = -(-cap // n_chunks)
    pad = n_chunks * c_sub - cap
    buf4 = buf.reshape(e, cap, d)
    if pad:
        buf4 = torch.nn.functional.pad(buf4, (0, 0, 0, pad))
    buf5 = buf4.reshape(1, e, n_chunks, c_sub, d)                # one tensor shard

    w1, wg, w2 = params["w1"], params["wg"], params["w2"]
    outs = []
    for ci in range(n_chunks):                                    # pipelined exchanges
        recv = _wire(buf5[:, :, ci], opts.payload, xs.dtype)      # [M, E_loc, c_sub, d]
        y = _expert_ffn(recv, w1, wg, w2)
        outs.append(_wire(y, opts.payload, xs.dtype))

    y5 = torch.stack(outs, dim=2)                                 # [M, E_loc, K, c_sub, d]
    y_flat = y5.reshape(e, n_chunks * c_sub, d)[:, :cap].reshape(e * cap, d)

    # ---- VOQ combine: weighted un-dispatch (dropped tokens contribute 0).
    # The reference scatter-adds in sorted order, one bfloat16 add at a
    # time; each token's k contributions are added here in that order.
    vals = y_flat[slot] * (gs * keep)[:, None]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=dev)
    seq = torch.sort(rank.reshape(t_m, k), dim=1).values          # [T_m, k]
    y_tok = torch.zeros((t_m, d), dtype=xs.dtype, device=dev)
    for j in range(k):
        y_tok = y_tok + vals[seq[:, j]]

    n = keep.shape[0]
    inv_n = torch.tensor(1.0 / n, dtype=torch.float32, device=dev)
    drop_frac = 1.0 - keep.sum().to(torch.float32) * inv_n
    return y_tok, aux, drop_frac, counts.to(torch.int32)


def apply_moe(
    params: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    plan: ShardingPlan,
    mesh: Optional[Mapping[str, int]],
    x: torch.Tensor,                    # [B, S, d]
    opts: Optional[MoEOptions] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The layer on ``x``'s device: (y [B, S, d], {"aux_loss", "drop_frac",
    "expert_load"}).  ``mesh`` is None or axis extents of 1 (see
    ``check_single_device``); ``plan`` names the axes, as in the reference."""
    del plan
    check_single_device(mesh)
    opts = opts or MoEOptions.from_config(cfg)
    if opts.weights not in ("gathered", "ff_sharded"):
        raise ValueError(f"unknown MoE weights mode {opts.weights!r}")
    b, s, d = x.shape
    y, aux, drops, occ = _fabric(x.reshape(b * s, d), params, cfg, opts)
    return y.reshape(b, s, d), {"aux_loss": aux, "drop_frac": drops,
                                "expert_load": occ}
