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

The port's copy of the JAX package's ``models/moe.py``.  The reference
runs the layer inside ``shard_map`` over the full mesh; the port runs each
shard of a ``launch.mesh.Mesh`` on its own device, one after another, and
does each collective between the shards' tensors itself: the all-to-alls
move blocks between shards, the all-gathers concatenate, and
``psum``/``pmean`` add in shard order.  With ``mesh=None`` (one device)
every collective is the identity.

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

The dropless layer (``init_dropless``, ``apply_dropless``: a layer
pattern's E, Nemotron-H's) is a second path, on one device, that drops
nothing.  The router's float32 sigmoid scores, with a correction bias added
only to choose the experts, pick the top-k of all ``moe_experts``; the
chosen k are normalised and scaled (``moe_scale``).
The device holds ``moe_held`` experts from ``moe_held_first`` (one shard of
an expert-parallel group) and computes their part of the result for every
pair routed to them: the pairs are sorted by held expert (the rest last)
into a buffer of all T·k pairs, each expert's rows end at a device-side
offset, and the experts' products are grouped products over those offsets
(``torch._grouped_mm`` on the card; a plain loop over the experts on the
CPU), so nothing waits on the host however the tokens fall.  The moves
between token order and the buffer are ``kernels.moe_dropless``
(``dispatch``, ``combine``): on the card hand-written kernels that read the
last offset on the device and touch the held experts' rows alone; on the
CPU plain statements that mask the rest.  The sum back to token order is
float32, as the published model's, each token's k rows taken through the
inverse of the sort in the order of its choices: no atomics, so the layer
is deterministic, and no blocking call.  The experts are relu²
(``w1``, ``w2``, no gate); an always-on shared expert of the same kind
(``moe_shared_ff``) is added whole.  Its aux is the held
experts' loads (``expert_load``, int32 on the device); there is no
load-balance loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.kernels import moe_dropless, quant_pack
from repro_torch.kernels.build import takes_plain
from repro_torch.launch.mesh import Mesh
from .config import ModelConfig, ShardingPlan
from .layers import dense_init, matmul

__all__ = ["MoEOptions", "init_moe", "apply_moe", "top_k", "router_matmul", "init_dropless",
           "sort_pairs", "apply_dropless", "grouped_mm", "GROUPED_LAUNCHES"]

#: grouped products the dropless layer launched on the card (forward calls)
GROUPED_LAUNCHES = 0

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


def expert_counts(ids: torch.Tensor, e: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=e)`` for ids in [0, e), int64,
    with a shape fixed by ``e``: integer adds, so bitwise bincount's on
    any device, and it runs on meta tensors, which bincount does not."""
    ids = ids.reshape(-1)
    return torch.zeros(e, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids.long(), torch.ones_like(ids, dtype=torch.int64))


def _route_learned(xs, router, topk):
    logits = router_matmul(xs.to(torch.float32), router)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = top_k(probs, topk)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    e = router.shape[-1]
    probs_mean = probs.mean(0)
    counts = expert_counts(experts, e).to(torch.float32)
    f = counts / counts.sum().clamp_min(1.0)
    aux = e * torch.sum(f * probs_mean)
    return experts, gates.to(xs.dtype), aux


def _route_hash(xs, hash_proj, topk, e):
    """MultiBankHash routing: k independent sign-LSH banks; conflicts appear
    as load imbalance -> capacity overflow (the paper's bank-conflict cost).
    The reference's uint32 arithmetic, in int64 masked to 32 bits."""
    proj = router_matmul(xs.to(torch.float32), hash_proj).detach()   # stop_gradient
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


class _Shards:
    """The shards of a mesh (or of one device, ``mesh=None``) and the
    collectives between them.  Each collective takes one value per shard
    (in shard order) and returns one per shard, on that shard's device;
    reductions add in shard order along the axis, as ``psum``/``pmean``."""

    def __init__(self, mesh, device: torch.device):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a launch.mesh.Mesh or None, got "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        if mesh is None:
            self.devices = (device,)
            self.coords = [{}]
        else:
            self.devices = mesh.devices
            self.coords = [dict(zip(mesh.axis_names, mesh.coords(s)))
                           for s in range(mesh.size)]

    def __len__(self) -> int:
        return len(self.devices)

    def extent(self, axis: str) -> int:
        if self.mesh is None:
            return 1
        if axis not in self.mesh.axis_names:
            raise ValueError(f"plan axis {axis!r} is not an axis of the mesh "
                             f"{self.mesh.axis_names}")
        return self.mesh.shape[axis]

    def index(self, s: int, axis: str) -> int:
        return self.coords[s].get(axis, 0)

    def peers(self, s: int, axis: str):
        """The shards that differ from shard s only along ``axis``, in
        order of their index there."""
        if self.mesh is None:
            return [s]
        base = self.coords[s]
        return [self.mesh.shard([i if a == axis else base[a]
                                 for a in self.mesh.axis_names])
                for i in range(self.extent(axis))]

    def all_to_all(self, vals, axis: str):
        """Shard i's block j (leading dim) becomes shard j's block i."""
        return [torch.stack([vals[p][self.index(s, axis)].to(self.devices[s])
                             for p in self.peers(s, axis)])
                for s in range(len(self))]

    def all_gather(self, vals, axis: str):
        """Concatenate the shards' values along dim 0, in axis order."""
        return [torch.cat([vals[p].to(self.devices[s])
                           for p in self.peers(s, axis)])
                for s in range(len(self))]

    def psum(self, vals, axis: str):
        out = []
        for s in range(len(self)):
            peers = self.peers(s, axis)
            acc = vals[peers[0]].to(self.devices[s])
            for p in peers[1:]:
                acc = acc + vals[p].to(self.devices[s])
            out.append(acc)
        return out

    def pmean(self, vals, axis: str):
        n = self.extent(axis)
        return [v / n for v in self.psum(vals, axis)]


def _exchange(shards: _Shards, vals, axis: str, payload: str, dtype):
    """One all-to-all over the fabric's ``axis``; the int8 payload is
    quantized on the sending shard before it and dequantized on the
    receiving shard after it (``quant_pack``: the CUDA kernels on a card)."""
    if payload != "int8":
        return shards.all_to_all(vals, axis)
    shape = vals[0].shape
    d = shape[-1]
    packed = [quant_pack.quantize(v.reshape(-1, d)) for v in vals]
    q = shards.all_to_all([c.reshape(shape) for c, _ in packed], axis)
    sc = shards.all_to_all([g.reshape(*shape[:-1], -1) for _, g in packed],
                           axis)
    return [quant_pack.dequantize(qi.reshape(-1, d), si.reshape(-1, si.shape[-1]),
                                  dtype).reshape(shape)
            for qi, si in zip(q, sc)]


def _dispatch(xs, params, cfg: ModelConfig, opts: MoEOptions, tp_size: int):
    """Route and VOQ-pack one shard's tokens xs [T_m, d]: the send buffer
    [M, E_loc, K, c_sub, d] and what the combine needs."""
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
    gs = g_flat[order]
    counts = expert_counts(es, e)                                 # queue occupancy
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(es.shape[0], device=dev) - starts[es]
    keep = pos < cap
    slot = torch.where(keep, es * cap + pos, torch.zeros_like(pos))
    # one token per kept slot; dropped entries add +0 to slot 0, as in the
    # reference (order-free: x + 0 == x), so the atomics on the card agree
    buf = torch.zeros((e * cap, d), dtype=xs.dtype, device=dev)
    buf.index_add_(0, slot, torch.where(keep[:, None], xs[order // k],
                                        torch.zeros((), dtype=xs.dtype,
                                                    device=dev)))

    n_chunks = max(1, min(opts.a2a_chunks, cap))
    c_sub = -(-cap // n_chunks)
    pad = n_chunks * c_sub - cap
    buf4 = buf.reshape(e, cap, d)
    if pad:
        buf4 = torch.nn.functional.pad(buf4, (0, 0, 0, pad))
    buf5 = buf4.reshape(tp_size, e // tp_size, n_chunks, c_sub, d)
    state = dict(t_m=t_m, cap=cap, order=order, gs=gs, keep=keep, slot=slot,
                 counts=counts, aux=aux)
    return buf5, state


def _combine(outs, st, cfg: ModelConfig, dtype):
    """Weighted un-dispatch of one shard's returned chunks (dropped tokens
    contribute 0): y [T_m, d], drop_frac, expert loads."""
    e, k = cfg.moe_experts, cfg.moe_topk
    t_m, cap, order = st["t_m"], st["cap"], st["order"]
    keep, slot, gs = st["keep"], st["slot"], st["gs"]
    y5 = torch.stack(outs, dim=2)                                 # [M, E_loc, K, c_sub, d]
    d = y5.shape[-1]
    dev = y5.device
    y_flat = y5.reshape(e, -1, d)[:, :cap].reshape(e * cap, d)
    # the reference scatter-adds in sorted order, one bfloat16 add at a
    # time; each token's k contributions are added here in that order
    vals = y_flat[slot] * (gs * keep)[:, None]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=dev)
    seq = torch.sort(rank.reshape(t_m, k), dim=1).values          # [T_m, k]
    y_tok = torch.zeros((t_m, d), dtype=dtype, device=dev)
    for j in range(k):
        y_tok = y_tok + vals[seq[:, j]]

    n = keep.shape[0]
    inv_n = torch.tensor(1.0 / n, dtype=torch.float32, device=dev)
    drop_frac = 1.0 - keep.sum().to(torch.float32) * inv_n
    return y_tok, drop_frac, st["counts"].to(torch.int32)


def apply_moe(
    params: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    plan: ShardingPlan,
    mesh: Optional[Mesh],
    x: torch.Tensor,                    # [B, S, d]
    opts: Optional[MoEOptions] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The layer: (y [B, S, d] on ``x``'s device, {"aux_loss", "drop_frac",
    "expert_load"}).

    ``mesh`` is None (one device: ``x``'s) or a ``launch.mesh.Mesh`` whose
    axes include the plan's (``compat_make_mesh((2, 4), ("data",
    "model"))``), as the reference's ``shard_map``: the batch splits over
    the dp axes, each shard takes a slice of its row's tokens by its
    ``tp`` index, packs its VOQ buffer at its own capacity, exchanges it
    with its ``tp`` peers (shard i's block j becomes shard j's block i, on
    shard j's device; the int8 payload quantized before and dequantized
    after, on both legs), runs its local experts and returns the results
    the same way; the outputs are gathered over ``tp`` and the statistics
    reduced over ``tp`` and dp in shard order.  ``weights="ff_sharded"``
    splits ``d_ff`` over the first fsdp axis and sums the partial FFNs."""
    opts = opts or MoEOptions.from_config(cfg)
    if opts.weights not in ("gathered", "ff_sharded"):
        raise ValueError(f"unknown MoE weights mode {opts.weights!r}")
    shards = _Shards(mesh, x.device)
    tp, dp = plan.tp_axis, tuple(plan.dp_axes)
    tp_size = shards.extent(tp)
    dp_sizes = [shards.extent(a) for a in dp]
    ff_axis = plan.fsdp_axes[0] if opts.weights == "ff_sharded" else None
    ff_size = shards.extent(ff_axis) if ff_axis else 1
    b, s_len, d = x.shape
    e = cfg.moe_experts
    n_dp = math.prod(dp_sizes)
    if b % n_dp or e % tp_size or cfg.d_ff % ff_size:
        raise ValueError(
            f"batch {b}, experts {e} and d_ff {cfg.d_ff} must split evenly "
            f"over the dp axes ({n_dp}), {tp!r} ({tp_size}) and the ff axis "
            f"({ff_size})")
    b_loc, e_loc, ff_loc = b // n_dp, e // tp_size, cfg.d_ff // ff_size

    def dp_row(s):
        r = 0
        for a, n in zip(dp, dp_sizes):
            r = r * n + shards.index(s, a)
        return r

    # ---- each shard's inputs on its device: its batch rows, its experts
    # (and d_ff slice), the router replicated
    flat, prm = [], []
    for s, dev in enumerate(shards.devices):
        r, j = dp_row(s), shards.index(s, tp)
        f = shards.index(s, ff_axis) if ff_axis else 0
        ex, ff = slice(j * e_loc, (j + 1) * e_loc), slice(f * ff_loc, (f + 1) * ff_loc)
        flat.append(x[r * b_loc:(r + 1) * b_loc].reshape(b_loc * s_len, d).to(dev))
        prm.append({"router": params["router"].to(dev),
                    "hash_proj": params["hash_proj"].to(dev),
                    "w1": params["w1"][ex, :, ff].to(dev),
                    "wg": params["wg"][ex, :, ff].to(dev),
                    "w2": params["w2"][ex, ff, :].to(dev)})
    t_row = flat[0].shape[0]
    if ff_axis:
        # expert-TP fabric: gather this row-group's tokens over the ff axis,
        # compute partial FFNs on every shard, psum the partials, then keep
        # our slice — zero weight movement
        flat = shards.all_gather(flat, ff_axis)
    t_loc = flat[0].shape[0]
    t_m = -(-t_loc // tp_size)                 # ceil: decode rows < tp_size
    bufs, states = [], []
    for s in range(len(shards)):
        f = flat[s]
        if t_m * tp_size > t_loc:
            f = torch.nn.functional.pad(f, (0, 0, 0, t_m * tp_size - t_loc))
        m = shards.index(s, tp)
        buf5, st = _dispatch(f[m * t_m:(m + 1) * t_m], prm[s], cfg, opts, tp_size)
        bufs.append(buf5)
        states.append(st)

    # ---- fabric exchange + expert compute, possibly in pipelined chunks
    outs = [[] for _ in range(len(shards))]
    for ci in range(bufs[0].shape[2]):
        recv = _exchange(shards, [bf[:, :, ci] for bf in bufs], tp,
                         opts.payload, x.dtype)               # [M, E_loc, c_sub, d]
        y = [_expert_ffn(rv, p["w1"], p["wg"], p["w2"]) for rv, p in zip(recv, prm)]
        if ff_axis:                                           # combine partial FFN sums
            y = shards.psum(y, ff_axis)
        y = _exchange(shards, y, tp, opts.payload, x.dtype)
        for s in range(len(shards)):
            outs[s].append(y[s])

    y_tok, drops, occ = zip(*(_combine(o, st, cfg, x.dtype)
                              for o, st in zip(outs, states)))
    y_all = shards.all_gather(list(y_tok), tp)                 # [T_loc(+pad), d]
    aux = shards.pmean([st["aux"] for st in states], tp)
    drops = shards.pmean(list(drops), tp)
    occ = shards.psum(list(occ), tp)
    for ax in dp:
        aux = shards.pmean(aux, ax)
        drops = shards.pmean(drops, ax)
        occ = shards.psum(occ, ax)
    # ---- out: the dp rows in order, each from its shard at index 0 on
    # every other axis
    rows = []
    for r in range(n_dp):
        s = next(s for s in range(len(shards)) if dp_row(s) == r
                 and all(shards.index(s, a) == 0 for a in shards.coords[s]
                         if a not in dp))
        y = y_all[s][:t_loc]
        if ff_axis:
            f = shards.index(s, ff_axis)
            y = y[f * t_row:(f + 1) * t_row]
        rows.append(y.reshape(b_loc, s_len, d).to(x.device))
    y = torch.cat(rows) if len(rows) > 1 else rows[0]
    return y, {"aux_loss": aux[0].to(x.device), "drop_frac": drops[0].to(x.device),
               "expert_load": occ[0].to(x.device)}


# ------------------------------------------------------------ dropless layer

def init_dropless(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The dropless layer's parameters: the float32 router [d, E] over all
    experts and its correction bias [E] (zero), the held experts' w1
    [E_held, d, ff] and w2 [E_held, ff, d], and the shared expert's
    shared_w1 [d, ff_s] and shared_w2 [ff_s, d]."""
    d, ff, sff, held = cfg.d_model, cfg.d_ff, cfg.moe_shared_ff, cfg.moe_local
    return {"router": dense_init(gen, (d, cfg.moe_experts), dtype=torch.float32),
            "e_bias": torch.zeros((cfg.moe_experts,), dtype=torch.float32, device=gen.device),
            "w1": dense_init(gen, (held, d, ff)),
            "w2": dense_init(gen, (held, ff, d), fan_in=ff),
            "shared_w1": dense_init(gen, (d, sff)),
            "shared_w2": dense_init(gen, (sff, d), fan_in=sff)}


def _relu2(h: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.relu(h))


def grouped_mm(a: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ w[e] [K, N] for the rows of expert e, rows offs[e-1] to
    offs[e] (int32 ends); rows past offs[-1] are left as they come.  On the
    card ``torch._grouped_mm`` (bf16, its own gradient); on the CPU a plain
    loop over the experts (meta tensors: the shape)."""
    global GROUPED_LAUNCHES
    if takes_plain(a):
        out = a.new_zeros((a.shape[0], w.shape[-1]))
        if a.is_meta:
            return out
        start = 0
        for e, end in enumerate(offs.tolist()):
            out[start:end] = matmul(a[start:end], w[e])
            start = end
        return out
    GROUPED_LAUNCHES += 1
    return torch._grouped_mm(a, w, offs=offs)


def _route(params, cfg: ModelConfig, xs: torch.Tensor):
    """(experts [T, k] over all E, gates [T, k] float32)."""
    scores = torch.sigmoid(router_matmul(xs.to(torch.float32), params["router"]))
    _, experts = top_k(scores.detach() + params["e_bias"].detach(), cfg.moe_topk)
    gates = scores.gather(-1, experts)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return experts, gates * cfg.moe_scale


def sort_pairs(experts: torch.Tensor, first: int, held: int):
    """The (token, expert) pairs of ``experts`` [T, k] sorted by held expert
    (experts ``first`` to ``first + held``), the held experts' pairs first:
    (order [T·k]: the pair at each row, pos [T, k]: the row of each pair,
    counts [held], offs int32 [held]: each held expert's end, count int32
    [1]: the last end), on the device, with no host sync."""
    t, k = experts.shape
    local = experts.reshape(-1) - first
    key = torch.where((local >= 0) & (local < held), local, held)
    order = torch.argsort(key, stable=True)
    counts = expert_counts(key, held + 1)[:held]
    pos = torch.empty_like(order).scatter_(0, order, torch.arange(t * k, device=order.device))
    offs = torch.cumsum(counts, 0).to(torch.int32)
    return order, pos.view(t, k), counts, offs, offs[-1:]


def apply_dropless(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                   x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, d] -> (the held experts' part of the routed sum plus the
    shared expert [B, S, d] in x's dtype, {"expert_load": int32 [E_held]})."""
    b, s, d = x.shape
    xs = x.reshape(b * s, d)
    held = cfg.moe_local
    with spans.span(spans.MOE_ROUTE):
        experts, gates = _route(params, cfg, xs)
        order, pos, counts, offs, count = sort_pairs(experts, cfg.moe_held_first, held)
    with spans.span(spans.MOE_EXPERTS):
        xin = moe_dropless.dispatch(xs, order, pos, count)
        y_rows = grouped_mm(_relu2(grouped_mm(xin, params["w1"], offs)), params["w2"], offs)
    with spans.span(spans.MOE_SHARED):
        shared = matmul(_relu2(matmul(xs, params["shared_w1"])), params["shared_w2"])
    with spans.span(spans.MOE_COMBINE):
        y = moe_dropless.combine(y_rows, gates, order, pos, count).to(x.dtype) + shared
    return y.reshape(b, s, d), {"expert_load": counts.to(torch.int32)}
