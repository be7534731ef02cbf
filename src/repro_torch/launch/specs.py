"""Meta-tensor stand-ins and partition specs for every dry-run cell.

The port's counterpart of the JAX package's ``launch/specs.py``.
``input_specs(cfg, shape, plan, mesh)`` returns abstract (no-allocation)
descriptions of every input of the counted step: the training batch for
``train_*``, the request batch for ``prefill``, and (token, KV-cache/SSM
state) for ``decode``.  Modality frontends are stubs, as in the reference:
``[vlm]``/``[audio]`` cells get precomputed patch/frame embeddings.

Where the reference has a ``jax.ShapeDtypeStruct`` the port has a tensor
on the ``meta`` device (a shape and a dtype, no storage), and where it has
a ``PartitionSpec`` the port has the plain tuple ``param_specs`` uses (per
dimension an axis name, a tuple of names, or None).  ``mesh`` is anything
with a ``shape`` mapping axis name -> extent (a ``launch.mesh.Mesh``).
There is no ``NamedSharding``: ``sharding_tree`` returns each leaf's spec,
sanitized against the mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShardingPlan
from repro_torch.train.optimizer import tree_map

__all__ = ["input_specs", "batch_specs", "abstract_params", "sharding_tree",
           "div_axes", "decode_state_specs"]

META = torch.device("meta")


def _extent(ax, mesh) -> int:
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    return total


def _sanitize_spec(shape, spec: Tuple, mesh) -> Tuple:
    """Drop axis entries whose mesh extent does not divide the dim size."""
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return tuple(None if ax is None or dim % _extent(ax, mesh) or dim < _extent(ax, mesh)
                 else ax for dim, ax in zip(shape, entries))


def sharding_tree(mesh, specs, structs):
    """Each leaf's spec sanitized against its shape (indivisible dims fall
    back to replication, e.g. vocab 50280 on a 16-way tensor axis)."""
    return tree_map(lambda st, s: _sanitize_spec(st.shape, s, mesh), structs, specs)


def div_axes(size: int, axes: Tuple[str, ...], mesh) -> Any:
    """Use the dp axes for a dim only if the size divides; else replicate."""
    total = _extent(axes, mesh)
    if size % total == 0 and size >= total:
        return axes if len(axes) > 1 else axes[0]
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, plan: ShardingPlan, mesh):
    """(meta tensor tree, spec tree) for one data batch."""
    b, s = shape.global_batch, shape.seq_len
    dp = div_axes(b, tuple(plan.dp_axes), mesh)
    structs: Dict[str, Any] = {}
    specs: Dict[str, Any] = {}
    if shape.kind == "train":
        structs["labels"] = _meta((b, s), torch.int32)
        specs["labels"] = (dp, None)
    if cfg.frontend == "tokens":
        structs["tokens"] = _meta((b, s), torch.int32)
        specs["tokens"] = (dp, None)
    else:
        structs["embeddings"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        specs["embeddings"] = (dp, None, None)
    if cfg.mrope:
        structs["positions3"] = _meta((b, 3, s), torch.int32)
        specs["positions3"] = (dp, None, None)
    return structs, specs


class _MetaFactories(TorchFunctionMode):
    """Every tensor factory called with a ``device`` allocates on ``meta``
    and draws nothing: ``init_params`` builds its tree without storage."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = META
            kwargs.pop("generator", None)
        return func(*args, **kwargs)


def abstract_params(cfg: ModelConfig, plan: ShardingPlan):
    """(meta parameter tree, spec tree) without allocation: ``init_params``'
    shapes and dtypes, no draw made."""
    with _MetaFactories():
        params = T.init_params(torch.Generator(), cfg, plan)
    return params, T.param_specs(cfg, plan)


def decode_state_specs(cfg: ModelConfig, plan: ShardingPlan, mesh, shape: ShapeSpec):
    """Abstract decode state + specs (divisibility-aware): the reference's
    ``decode_state_structs`` rule, the KV cache sharded on its sequence
    (``shard_kv_seq_decode``) or its heads over the tensor axis."""
    dp, tp = tuple(plan.dp_axes), plan.tp_axis
    dp = dp if len(dp) > 1 else dp[0]      # a PartitionSpec holds ("data",) as "data"
    structs = {k: _meta(shp, dt) for k, (shp, dt) in
               T.decode_state_structs(cfg, plan, shape.global_batch, shape.seq_len).items()}
    specs: Dict[str, Tuple] = {"pos": ()}
    if cfg.has_attention:
        seq_ax = tp if plan.shard_kv_seq_decode else None
        head_ax = None if plan.shard_kv_seq_decode else tp
        specs["cache_k"] = specs["cache_v"] = (None, dp, head_ax, seq_ax, None)
    if cfg.has_ssm:
        specs["ssm"] = (None, dp, None, None)
        specs["conv"] = (None, dp, None, tp)
    return structs, {k: _sanitize_spec(structs[k].shape, s, mesh) for k, s in specs.items()}


def input_specs(cfg: ModelConfig, shape: ShapeSpec, plan: ShardingPlan, mesh,
                *, opt=None) -> Dict[str, Any]:
    """Everything the dry-run needs to count one cell."""
    params_s, params_spec = abstract_params(cfg, plan)
    out: Dict[str, Any] = {
        "params": params_s,
        "params_spec": params_spec,
    }
    if shape.kind == "train":
        batch_s, batch_spec = batch_specs(cfg, shape, plan, mesh)
        out.update(batch=batch_s, batch_spec=batch_spec)
        if opt is not None:
            out["opt_state"] = opt.init(params_s)
            out["opt_spec"] = opt.state_specs(params_spec)
    elif shape.kind == "prefill":
        batch_s, batch_spec = batch_specs(cfg, shape, plan, mesh)
        out.update(batch=batch_s, batch_spec=batch_spec)
    else:  # decode / long_decode
        b = shape.global_batch
        dp = div_axes(b, tuple(plan.dp_axes), mesh)
        if cfg.frontend == "tokens":
            out["tok"] = _meta((b, 1), torch.int32)
            out["tok_spec"] = (dp, None)
        else:
            out["tok"] = _meta((b, 1, cfg.d_model), torch.bfloat16)
            out["tok_spec"] = (dp, None, None)
        state_s, state_spec = decode_state_specs(cfg, plan, mesh, shape)
        out["state"] = state_s
        out["state_spec"] = state_spec
    return out

