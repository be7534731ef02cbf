"""Model composition: blocks, the layer loop, forward, prefill, decode step.

The port's counterpart of the JAX package's ``models/transformer.py``.  One
code path serves all 10 architectures; the block is assembled from the
config's family:

  dense / vlm / audio  : rmsnorm → GQA attn → rmsnorm → gated MLP
  moe                  : rmsnorm → GQA attn → rmsnorm → switch-fabric MoE
  ssm                  : rmsnorm → Mamba-2 SSD mix (attention-free)
  hybrid (hymba)       : rmsnorm → ½·(attn ‖ SSD) parallel heads → rmsnorm → MLP
  layer_pattern        : one mixer a layer, in the pattern's order (Nemotron-H):
                         rmsnorm → Mamba-2 (M) | dropless MoE (E) | attention (*)

Under a ``layer_pattern`` each kind's layers are stacked on their own leading
dimension, ``params["layers"]["mamba" | "moe" | "attn"]``, each holding its
norm ``ln1`` beside the mixer's leaves; the loop takes layer i from its
kind's stack by its place among that kind's layers.  Each stack is split
into its layers once a forward, outside the layers' checkpoints, so the
backward stacks the layers' gradients once (one ``UnbindBackward0`` a
leaf) where a per-layer select would write a zero gradient the size of the
whole stack for each layer.  Serving (``prefill``, ``decode_step``) is not
ported for a pattern and raises.

Parameters keep the reference's layout — every layer weight stacked on a
leading L dimension — so that weights carry across one to one; the scan over
layers is a Python loop over ``params["layers"][...][i]`` (indexing keeps
each layer's gradient flowing to the stacked leaf).  The reference's
sharding constraints have no counterpart: the port keeps parameters whole
on one device (``plan`` and ``mesh`` name axes as in the reference; only the
MoE layer runs over a mesh's shards), and ``param_specs`` gives the
reference's spec tree as plain tuples.  ``loss_fn`` is the training loss;
autograd differentiates it, through the kernels' autograd Functions on the
card.  ``remat="block"`` (the configs' default) recomputes each layer's
block in the backward pass (``torch.utils.checkpoint``, non-reentrant),
the counterpart of the reference's ``jax.checkpoint``; under ``no_grad``
(serving) it does nothing.  Each block runs in the ``model.block`` span
(``model.block.recompute`` inside the backward) and the loss in
``model.loss`` (``repro_torch.spans``: free unless a profiler records).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import spans

from . import attention as attn_mod
from . import mamba2 as ssm_mod
from . import moe as moe_mod
from .config import ModelConfig, ShardingPlan
from .layers import (apply_mlp, init_embedding, init_mlp, init_norm, init_unembed,
                     matmul, rms_norm)

__all__ = ["init_params", "param_specs", "forward", "loss_fn", "init_decode_state",
           "decode_state_structs", "prefill", "decode_step", "ModelBundle"]


# --------------------------------------------------------------------- init

def _init_block(gen: torch.Generator, cfg: ModelConfig, plan) -> Dict[str, Any]:
    params: Dict[str, Any] = {"ln1": init_norm(cfg, gen.device)}
    if cfg.has_attention:
        params["attn"] = attn_mod.init_attention(gen, cfg, plan)
    if cfg.has_ssm:
        params["ssm"] = ssm_mod.init_mamba(gen, cfg, plan)
    if cfg.family == "ssm":
        return params                            # mamba2: single-mix block, no MLP
    params["ln2"] = init_norm(cfg, gen.device)
    if cfg.is_moe:
        params["moe"] = moe_mod.init_moe(gen, cfg, plan)
    else:
        params["mlp"] = init_mlp(gen, cfg, plan)
    return params


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree) -> list:
    """A stacked tree's layers, each a tree of views (one ``unbind`` a leaf)."""
    views = {k: v.unbind(0) for k, v in tree.items()}
    n = len(next(iter(views.values())))
    return [{k: v[i] for k, v in views.items()} for i in range(n)]


def _init_mixer(gen: torch.Generator, cfg: ModelConfig, plan, kind: str) -> Dict[str, Any]:
    """One layer of a pattern: its norm and its mixer's leaves."""
    init = {"mamba": lambda: ssm_mod.init_mamba(gen, cfg, plan),
            "moe": lambda: moe_mod.init_dropless(gen, cfg),
            "attn": lambda: attn_mod.init_attention(gen, cfg, plan)}[kind]
    return {"ln1": init_norm(cfg, gen.device), **init()}


def _init_pattern(gen: torch.Generator, cfg: ModelConfig, plan) -> Dict[str, Any]:
    layers: Dict[str, list] = {}
    for kind in cfg.kinds:
        layers.setdefault(kind, []).append(_init_mixer(gen, cfg, plan, kind))
    return {kind: _stack(trees) for kind, trees in layers.items()}


def _places(cfg: ModelConfig):
    """(kind, index in that kind's stack) of each layer of a pattern."""
    seen: Dict[str, int] = {}
    out = []
    for kind in cfg.kinds:
        out.append((kind, seen.get(kind, 0)))
        seen[kind] = out[-1][1] + 1
    return out


def init_params(gen: torch.Generator, cfg: ModelConfig,
                plan: Optional[ShardingPlan] = None) -> Dict[str, Any]:
    """The model's parameters, drawn from ``gen`` on its device, with the
    layers stacked on a leading L dimension (no partition specs)."""
    params: Dict[str, Any] = {}
    if cfg.frontend == "tokens":
        params["embed"] = init_embedding(gen, cfg, plan)
    params["unembed"] = init_unembed(gen, cfg, plan)
    params["final_norm"] = init_norm(cfg, gen.device)
    if cfg.layer_pattern:
        params["layers"] = _init_pattern(gen, cfg, plan)
    else:
        params["layers"] = _stack([_init_block(gen, cfg, plan)
                                   for _ in range(cfg.n_layers)])
    return params


def _fsdp(plan: ShardingPlan):
    if not plan.fsdp_weights:
        return None
    axes = tuple(plan.fsdp_axes)
    return axes if len(axes) > 1 else axes[0]


def _block_specs(cfg: ModelConfig, plan: ShardingPlan) -> Dict[str, Any]:
    fs, tp = _fsdp(plan), plan.tp
    specs: Dict[str, Any] = {"ln1": (None,)}
    if cfg.has_attention:
        specs["attn"] = {"wq": (fs, tp), "wk": (fs, tp), "wv": (fs, tp), "wo": (tp, fs)}
    if cfg.has_ssm:
        specs["ssm"] = {"wz": (fs, tp), "wx": (fs, tp), "wb": (fs, None), "wc": (fs, None),
                        "wdt": (fs, tp), "conv_w": (tp, None), "a_log": (tp,),
                        "dskip": (tp,), "dt_bias": (tp,), "norm_g": (tp,), "wo": (tp, fs)}
    if cfg.family == "ssm":
        return specs
    specs["ln2"] = (None,)
    if cfg.is_moe:
        ep = plan.tp_axis                          # experts over the tensor axis
        specs["moe"] = {"router": (None, None), "hash_proj": (None, None),
                        "w1": (ep, fs, None), "wg": (ep, fs, None), "w2": (ep, None, fs)}
    else:
        specs["mlp"] = {"wi": (fs, tp), "wg": (fs, tp), "wo": (tp, fs)}
    return specs


def _pattern_specs(cfg: ModelConfig, plan: ShardingPlan) -> Dict[str, Any]:
    """Each kind's leaves: its mixer's specs beside its norm's; the held
    experts over the tensor axis, the shared expert as an MLP."""
    fs, tp = _fsdp(plan), plan.tp
    block = _block_specs(dataclasses.replace(cfg, family="hybrid", moe_experts=0), plan)
    moe = {"router": (None, None), "e_bias": (None,), "w1": (plan.tp_axis, fs, None),
           "w2": (plan.tp_axis, None, fs), "shared_w1": (fs, tp), "shared_w2": (tp, fs)}
    ssm = dict(block["ssm"], conv_b=(tp,), bconv_b=(None,), cconv_b=(None,),
               bconv_w=(None, None), cconv_w=(None, None))
    mixers = {"mamba": ssm, "moe": moe, "attn": block["attn"]}
    from repro_torch.launch.specs import _MetaFactories     # the leaves, no storage
    out = {}
    for kind in dict.fromkeys(cfg.kinds):
        with _MetaFactories():
            keys = _init_mixer(torch.Generator(), cfg, plan, kind).keys()
        out[kind] = {k: (None,) if k == "ln1" else mixers[kind][k] for k in keys}
    return out


def param_specs(cfg: ModelConfig, plan: ShardingPlan) -> Dict[str, Any]:
    """The reference's spec tree without allocating parameters: one tuple
    per leaf, holding what its ``PartitionSpec`` holds (an axis name, a
    tuple of names, or None per dimension), with a leading None on every
    ``layers`` leaf."""
    fs, tp = _fsdp(plan), plan.tp
    specs: Dict[str, Any] = {}
    if cfg.frontend == "tokens":
        specs["embed"] = (None, tp) if plan.embed_dmodel_sharded else (tp, fs)
    specs["unembed"] = (fs, tp)
    specs["final_norm"] = (None,)

    def stacked(tree):
        if isinstance(tree, dict):
            return {k: stacked(v) for k, v in tree.items()}
        return (None,) + tree
    specs["layers"] = stacked(_pattern_specs(cfg, plan) if cfg.layer_pattern
                              else _block_specs(cfg, plan))
    return specs


# ------------------------------------------------------------------- forward

def _inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Embedded inputs [B, S, d] and their positions."""
    if cfg.frontend == "tokens":
        tok = batch["tokens"]
        x = params["embed"].to(cfg.activation_dtype)[tok]
        b, s = tok.shape
    else:
        x = batch["embeddings"].to(cfg.activation_dtype)
        b, s = x.shape[:2]
    dev = x.device
    if cfg.mrope:
        positions = batch.get("positions3")
        if positions is None:
            base = torch.arange(s, device=dev)[None].expand(b, s)
            positions = torch.stack([base, base, base], dim=1)
    else:
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, device=dev)[None].expand(b, s)
    return x, positions


def _block_apply(layers, i: int, cfg: ModelConfig, plan: ShardingPlan, mesh,
                 x, positions, moe_opts, window: int):
    """Layer ``i``'s block, its weights sliced from the stacked ``layers``
    inside the block's span (their gradient's scatter into the stacked leaf
    is the block's backward)."""
    with spans.block_span():
        return _block(_layer(layers, i), cfg, plan, mesh, x, positions, moe_opts, window)


def _mixer_apply(lp, kind: str, cfg: ModelConfig, x, positions):
    """One layer of ``kind`` under a pattern, its weights ``lp``, in the
    block's span."""
    with spans.block_span():
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if kind == "mamba":
            return x + ssm_mod.apply_mamba(lp, cfg, h), {}
        if kind == "attn":
            return x + attn_mod.apply_attention(lp, cfg, h, positions), {}
        y, aux = moe_mod.apply_dropless(lp, cfg, h)
        return x + y, aux


def _pattern_hidden(params, cfg: ModelConfig, x, positions):
    """The pattern's layers in order; aux: ``expert_load`` [MoE layers,
    held experts]."""
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    stacks = {kind: _unbind(tree) for kind, tree in params["layers"].items()}
    loads = []
    for kind, i in _places(cfg):
        args = (stacks[kind][i], kind, cfg, x, positions)
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(_mixer_apply, *args, use_reentrant=False)
        else:
            x, aux = _mixer_apply(*args)
        if aux:
            loads.append(aux["expert_load"])
    return x, ({"expert_load": torch.stack(loads)} if loads else {})


def _no_pattern(cfg: ModelConfig, what: str) -> None:
    if cfg.layer_pattern:
        raise NotImplementedError(f"{what} is not ported for a layer pattern "
                                  f"({cfg.name}: training only)")


def _block(layer_params, cfg: ModelConfig, plan: ShardingPlan, mesh,
           x, positions, moe_opts, window: int):
    h = rms_norm(x, layer_params["ln1"], cfg.norm_eps)
    aux: Dict[str, torch.Tensor] = {}
    if cfg.family == "ssm":
        return x + ssm_mod.apply_mamba(layer_params["ssm"], cfg, h), aux
    if cfg.family == "hybrid":
        a = attn_mod.apply_attention(layer_params["attn"], cfg, h, positions, window=window)
        m = ssm_mod.apply_mamba(layer_params["ssm"], cfg, h)
        x = x + 0.5 * (a + m)                       # parallel heads (Hymba)
    else:
        x = x + attn_mod.apply_attention(layer_params["attn"], cfg, h, positions,
                                         window=window)
    h2 = rms_norm(x, layer_params["ln2"], cfg.norm_eps)
    if cfg.is_moe:
        y, aux = moe_mod.apply_moe(layer_params["moe"], cfg, plan, mesh, h2, moe_opts)
        x = x + y
    else:
        x = x + apply_mlp(layer_params["mlp"], h2)
    return x, aux


def _unembed(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return matmul(x, params["unembed"].to(x.dtype))


def _hidden(params, cfg: ModelConfig, plan: ShardingPlan, mesh,
            batch: Dict[str, torch.Tensor], moe_opts, window: int):
    """The last block's output [B, S, d] and ``forward``'s aux."""
    x, positions = _inputs(params, cfg, batch)
    if cfg.layer_pattern:
        return _pattern_hidden(params, cfg, x, positions)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    auxs = []
    for i in range(cfg.n_layers):
        args = (params["layers"], i, cfg, plan, mesh, x, positions, moe_opts, window)
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(_block_apply, *args, use_reentrant=False)
        else:
            x, aux = _block_apply(*args)
        auxs.append(aux)
    if not auxs or not auxs[0]:
        return x, {}
    return x, {k: torch.stack([a[k] for a in auxs]).float().mean() for k in auxs[0]}


def forward(
    params,
    cfg: ModelConfig,
    plan: ShardingPlan,
    mesh,
    batch: Dict[str, torch.Tensor],
    *,
    moe_opts: Optional[moe_mod.MoEOptions] = None,
    window: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token/embedding batch -> logits [B, S, V] (+ aux: the MoE layers'
    ``aux_loss``/``drop_frac``/``expert_load`` averaged over layers)."""
    x, aux = _hidden(params, cfg, plan, mesh, batch, moe_opts, window)
    return _unembed(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, plan: ShardingPlan, mesh,
            batch: Dict[str, torch.Tensor], *, moe_opts=None, window: int = 0,
            aux_weight: float = 0.01):
    """(loss, metrics): the mean next-token cross-entropy over labels >= 0
    (float32 logits, log-sum-exp minus the gold logit), plus ``aux_weight``
    times the MoE load-balance loss; metrics ``loss``, ``tokens`` and the
    forward's aux values."""
    x, aux = _hidden(params, cfg, plan, mesh, batch, moe_opts, window)
    with spans.span(spans.LOSS):
        logits = _unembed(params, cfg, x)
        labels = batch["labels"].long()
        logits = logits.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
        nll = logz - gold
        mask = (labels >= 0).to(torch.float32)
        loss = torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
    if aux and "aux_loss" in aux:
        loss = loss + aux_weight * aux["aux_loss"]
    metrics = {"loss": loss, "tokens": mask.sum(), **aux}
    return loss, metrics


# ------------------------------------------------------------------- prefill

def prefill(
    params,
    cfg: ModelConfig,
    plan: ShardingPlan,
    mesh,
    batch: Dict[str, torch.Tensor],
    *,
    moe_opts: Optional[moe_mod.MoEOptions] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Serving prefill: consume the prompt, emit (last-token logits [B, V],
    decode state with per-layer caches stacked on L and ``pos``)."""
    _no_pattern(cfg, "prefill")
    x, positions = _inputs(params, cfg, batch)
    s = x.shape[1]
    window = cfg.sliding_window
    cache_len = min(window, s) if window else s
    caches = []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.family == "ssm":
            y, st = ssm_mod.apply_mamba(lp["ssm"], cfg, h, return_state=True)
            x = x + y
            caches.append(st)
            continue
        if cfg.family == "hybrid":
            a, ck, cv = attn_mod.apply_attention(lp["attn"], cfg, h, positions,
                                                 window=window, return_kv=True)
            m, st = ssm_mod.apply_mamba(lp["ssm"], cfg, h, return_state=True)
            x = x + 0.5 * (a + m)
            cache = {"cache_k": ck[:, :, -cache_len:], "cache_v": cv[:, :, -cache_len:], **st}
        else:
            a, ck, cv = attn_mod.apply_attention(lp["attn"], cfg, h, positions,
                                                 return_kv=True)
            x = x + a
            cache = {"cache_k": ck[:, :, -cache_len:], "cache_v": cv[:, :, -cache_len:]}
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        if cfg.is_moe:
            y, _ = moe_mod.apply_moe(lp["moe"], cfg, plan, mesh, h2, moe_opts)
            x = x + y
        else:
            x = x + apply_mlp(lp["mlp"], h2)
        caches.append(cache)
    logits = _unembed(params, cfg, x[:, -1:])
    state: Dict[str, Any] = _stack(caches)
    state["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    return logits[:, 0], state


# -------------------------------------------------------------------- decode

def decode_state_structs(cfg: ModelConfig, plan: Optional[ShardingPlan], batch: int,
                         s_max: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Decode-state shapes and dtypes, without allocating (the reference
    also returns shardings; one device has none)."""
    _no_pattern(cfg, "the decode state")
    del plan
    structs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {"pos": ((), torch.int32)}
    if cfg.has_attention:
        hkv, hd = cfg.n_kv_heads, cfg.hd
        cache_len = min(cfg.sliding_window or s_max, s_max)
        shape = (cfg.n_layers, batch, hkv, cache_len, hd)
        structs["cache_k"] = (shape, cfg.activation_dtype)
        structs["cache_v"] = (shape, cfg.activation_dtype)
    if cfg.has_ssm:
        h, p, n, di = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_inner
        structs["ssm"] = ((cfg.n_layers, batch * h, p, n), torch.float32)
        structs["conv"] = ((cfg.n_layers, batch, cfg.ssm_conv - 1, di),
                           cfg.activation_dtype)
    return structs


def init_decode_state(cfg: ModelConfig, plan: Optional[ShardingPlan], batch: int,
                      s_max: int, device=None) -> Dict[str, torch.Tensor]:
    """Zeroed per-layer caches/states (stacked on L) and ``pos`` = 0 on
    ``device`` (default: the first CUDA device)."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in decode_state_structs(cfg, plan, batch, s_max).items()}


def decode_step(
    params,
    cfg: ModelConfig,
    plan: ShardingPlan,
    mesh,
    state: Dict[str, Any],
    tokens_or_embeds: torch.Tensor,           # [B, 1] int or [B, 1, d]
    *,
    moe_opts: Optional[moe_mod.MoEOptions] = None,
) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One serving step: consume one token, emit next-token logits [B, 1, V].
    ``pos`` stays a device scalar: nothing here waits on the host."""
    _no_pattern(cfg, "decode_step")
    pos = state["pos"]
    if cfg.frontend == "tokens":
        x = params["embed"].to(cfg.activation_dtype)[tokens_or_embeds]
    else:
        x = tokens_or_embeds.to(cfg.activation_dtype)
    b = x.shape[0]
    pq = pos.reshape(1, 1).expand(b, 1)
    positions_q = torch.stack([pq, pq, pq], dim=1) if cfg.mrope else pq
    window = cfg.sliding_window

    cache_keys = [k for k in ("cache_k", "cache_v", "ssm", "conv") if k in state]
    new_caches = []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        cache = {k: state[k][i] for k in cache_keys}
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if cfg.family == "ssm":
            st, y = ssm_mod.decode_mamba(lp["ssm"], cfg, cache, h)
            x = x + y
            new_caches.append(st)
            continue
        if cfg.family == "hybrid":
            a, ck, cv = attn_mod.decode_attention(
                lp["attn"], cfg, h, cache["cache_k"], cache["cache_v"],
                pos % cache["cache_k"].shape[2], positions_q, ring=True)
            st, m = ssm_mod.decode_mamba(lp["ssm"], cfg,
                                         {"ssm": cache["ssm"], "conv": cache["conv"]}, h)
            x = x + 0.5 * (a + m)
            new_cache = {"cache_k": ck, "cache_v": cv, **st}
        else:
            a, ck, cv = attn_mod.decode_attention(
                lp["attn"], cfg, h, cache["cache_k"], cache["cache_v"],
                pos, positions_q, window=window)
            x = x + a
            new_cache = {"cache_k": ck, "cache_v": cv}
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        if cfg.is_moe:
            y, _ = moe_mod.apply_moe(lp["moe"], cfg, plan, mesh, h2, moe_opts)
            x = x + y
        else:
            x = x + apply_mlp(lp["mlp"], h2)
        new_caches.append(new_cache)
    logits = _unembed(params, cfg, x)
    new_state = dict(state)
    new_state.update(_stack(new_caches))
    new_state["pos"] = pos + 1
    return new_state, logits


@dataclasses.dataclass
class ModelBundle:
    """Convenience wrapper used by the launcher and examples."""

    cfg: ModelConfig
    plan: ShardingPlan
    mesh: Any

    def init(self, gen: torch.Generator):
        return init_params(gen, self.cfg, self.plan)

    def loss(self, params, batch, **kw):
        return loss_fn(params, self.cfg, self.plan, self.mesh, batch, **kw)

    def decode(self, params, state, tok, **kw):
        return decode_step(params, self.cfg, self.plan, self.mesh, state, tok, **kw)
