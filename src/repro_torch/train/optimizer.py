"""Optimizers: AdamW (fp32 or bf16 state) and Adafactor (factored 2nd moment).

The port's counterpart of the JAX package's ``train/optimizer.py``, as plain
functions on nested dicts of tensors with the reference's state layout:

  AdamW      ``{"mu", "nu", "count"}``
  Adafactor  ``{"v": {... {"vr", "vc"} or {"v"}}, "count"}``

``count`` is an int32 scalar tensor.  The arithmetic follows the
reference's dtype steps: every update in float32, cast back to the
parameter's dtype; weight decay only on leaves with ``ndim >= 2``; the bias
correction from ``count`` as a float32 scalar; Adafactor's RMS update
clipping.  Python floats (``b1``, ``eps``, ...) meet float32 tensors as
float32 numbers, as JAX's weakly typed scalars do.  ``state_specs`` maps the
port's spec tree (``models.transformer.param_specs``: one tuple per leaf,
as a ``PartitionSpec`` holds its entries) to the state's.

State lives with the parameters (same device); the reference's note on
sharding it like them (ZeRO) applies to a mesh the port does not shard
parameters over.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

__all__ = ["Optimizer", "adamw", "adafactor", "clip_by_global_norm", "is_spec",
           "tree_leaves", "tree_map"]

f32 = torch.float32


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict (or list/tuple) in ``jax.tree.leaves``
    order: dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``jax.tree.map`` over nested dicts (and lists/tuples) of the same
    structure, visiting leaves in ``tree_leaves`` order (the dicts it builds
    have their keys sorted); ``is_leaf`` stops the descent where it returns
    True."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def is_spec(x) -> bool:
    """A spec: a tuple of axis names, tuples of names, or None (a
    ``PartitionSpec``'s entries); a tuple of anything else is a container."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(n, str) for n in e)) for e in x)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]                      # params -> opt_state
    update: Callable[..., Tuple[Any, Any]]          # (grads, state, params, lr) -> (params, state)
    state_specs: Callable[[Any], Any]               # param specs -> state specs


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm).
    The squares are summed per leaf in float32 and the leaves' sums added
    in ``jax.tree.leaves`` order (sorted dict keys), as the reference does."""
    leaves = tree_leaves(grads)
    total = None
    for leaf in leaves:
        sq = torch.sum(leaf.to(f32) ** 2)
        total = sq if total is None else total + sq
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(f32) * scale).to(g.dtype), grads), gn


def _lr(step_lr, lr):
    return step_lr if step_lr is not None else lr


def adamw(
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    state_dtype: torch.dtype = f32,
) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)  # noqa: E731
        dev = tree_leaves(params)[0].device
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, step_lr=None):
        count = state["count"] + 1
        cf = count.to(f32)
        a = _lr(step_lr, lr) * torch.sqrt(1 - b2 ** cf) / (1 - b1 ** cf)
        decay_lr = _lr(step_lr, lr)

        def upd(g, mu, nu, p):
            g = g.to(f32)
            mu_n = b1 * mu.to(f32) + (1 - b1) * g
            nu_n = b2 * nu.to(f32) + (1 - b2) * g * g
            step = a * mu_n / (torch.sqrt(nu_n) + eps)
            if weight_decay and p.dim() >= 2:
                step = step + decay_lr * weight_decay * p.to(f32)
            return ((p.to(f32) - step).to(p.dtype), mu_n.to(state_dtype),
                    nu_n.to(state_dtype))

        out = tree_map(upd, grads, state["mu"], state["nu"], params)
        is_out = lambda x: isinstance(x, tuple)    # noqa: E731
        new_params = tree_map(lambda t: t[0], out, is_leaf=is_out)
        mu = tree_map(lambda t: t[1], out, is_leaf=is_out)
        nu = tree_map(lambda t: t[2], out, is_leaf=is_out)
        return new_params, {"mu": mu, "nu": nu, "count": count}

    def state_specs(param_specs):
        return {"mu": param_specs, "nu": param_specs, "count": ()}

    return Optimizer(init, update, state_specs)


def adafactor(
    lr: float = 1e-3,
    decay: float = 0.8,
    eps: float = 1e-30,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Factored second moment for >=2-D params (memory: 2·(r+c) vs r·c)."""

    def _factored(p):
        return p.dim() >= 2

    def init(params):
        def per(p):
            dev = p.device
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=f32, device=dev),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=f32,
                                          device=dev)}
            return {"v": torch.zeros(p.shape, dtype=f32, device=dev)}
        dev = tree_leaves(params)[0].device
        return {"v": tree_map(per, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, step_lr=None):
        count = state["count"] + 1
        beta = 1.0 - count.to(f32) ** -decay
        a = _lr(step_lr, lr)

        def upd(g, p, v):
            g = g.to(f32)
            if _factored(p):
                g2 = g * g + eps
                vr = beta * v["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(-2)
                denom = (vr[..., None] * vc[..., None, :]) / torch.clamp(
                    vr.mean(-1)[..., None, None], min=eps)
                step = g / torch.sqrt(torch.clamp(denom, min=eps))
                nv = {"vr": vr, "vc": vc}
            else:
                vv = beta * v["v"] + (1 - beta) * (g * g + eps)
                step = g / torch.sqrt(torch.clamp(vv, min=eps))
                nv = {"v": vv}
            # update clipping (RMS<=1) as in the paper's Adafactor
            rms = torch.sqrt(torch.mean(step ** 2))
            step = step / torch.clamp(rms, min=1.0)
            newp = p.to(f32) - a * step
            if weight_decay and p.dim() >= 2:
                newp = newp - a * weight_decay * p.to(f32)
            return newp.to(p.dtype), nv

        # the state's per-leaf dicts sit where the params have tensors
        flat = tree_map(upd, grads, params, state["v"])
        is_out = lambda x: isinstance(x, tuple)    # noqa: E731
        new_params = tree_map(lambda t: t[0], flat, is_leaf=is_out)
        v = tree_map(lambda t: t[1], flat, is_leaf=is_out)
        return new_params, {"v": v, "count": count}

    def state_specs(param_specs):
        def per(spec):
            # vr drops the last dim's spec entry, vc the second-to-last
            s = tuple(spec)
            if len(s) >= 2:
                return {"vr": s[:-1], "vc": s[:-2] + s[-1:]}
            return {"v": s}

        return {"v": tree_map(per, param_specs, is_leaf=is_spec), "count": ()}

    return Optimizer(init, update, state_specs)
