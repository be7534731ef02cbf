"""Training step factory: microbatched grad accumulation, clipping, LR
schedule, optional compressed cross-pod gradient protocol.

The port's counterpart of the JAX package's ``train/train_step.py``.
``make_train_step`` returns a function
    (params, opt_state, batch, step) -> (params, opt_state, metrics)
where ``jax.value_and_grad`` becomes ``torch.autograd.grad`` of
``models.transformer.loss_fn`` (parameters that reach no gradient, such as
the MoE hash router's LSH projection, get zeros, as ``jax.grad`` gives).
The global batch is split into ``microbatches`` chunks on axis 0 and the
gradients accumulated in float32 in the reference's order (a Python loop in
place of its ``lax.scan``).  Batches may hold NumPy arrays (moved to the
parameters' device) or tensors.

The step marks its phases with ``repro_torch.spans`` (``train.step``,
``train.forward``, ``train.backward``, ``train.clip``, ``train.lr``,
``train.optimizer``) for a recording ``torch.profiler``.

``TrainSpec.shard_grads`` is a GSPMD placement hint in the reference (a
``with_sharding_constraint`` with no numeric effect); the port accepts it
and does nothing with it, as it does for ``sp_activations``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShardingPlan
from repro_torch.models.moe import MoEOptions
from .optimizer import Optimizer, clip_by_global_norm, tree_leaves, tree_map

__all__ = ["TrainSpec", "make_train_step", "lr_schedule", "value_and_grad",
           "batch_to"]

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    microbatches: int = 1
    max_grad_norm: float = 1.0
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "wsd"            # wsd (minicpm) | cosine | const
    moe_opts: Optional[MoEOptions] = None
    compress_pod_grads: bool = False  # int8 cross-pod gradient protocol
    shard_grads: bool = False         # a placement hint in the reference; no-op here


def _f32(x: float, device=None) -> torch.Tensor:
    return torch.tensor(x, dtype=f32, device=device)


def lr_schedule(spec: TrainSpec, step) -> torch.Tensor:
    """The learning rate at ``step`` as a float32 scalar, computed in the
    reference's float32 steps (its Python constants rounded to float32 as
    JAX's weakly typed scalars are)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    s = torch.as_tensor(step, device=dev).to(f32)
    warm = torch.clamp(s / max(spec.warmup_steps, 1), max=1.0)
    if spec.schedule == "cosine":
        frac = torch.clamp(s / spec.total_steps, 0.0, 1.0)
        base = 0.5 * (1 + torch.cos(_f32(math.pi, dev) * frac))
    elif spec.schedule == "wsd":                      # warmup-stable-decay
        decay_start = 0.9 * spec.total_steps
        frac = torch.clamp((s - decay_start) / (0.1 * spec.total_steps), 0.0, 1.0)
        base = 1.0 - frac * (1.0 - 0.1)
    else:
        base = torch.ones((), dtype=f32, device=dev)
    return spec.lr * warm * base


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of NumPy arrays or tensors as tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(device)
    return out


def value_and_grad(loss_for: Callable) -> Callable:
    """``jax.value_and_grad(loss_for, has_aux=True)``: (params, batch) ->
    ((loss, metrics), grads), grads in the parameters' tree and dtypes (zeros
    for a leaf no gradient reaches), loss and metrics detached."""

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            it = iter(live)
            tracked = tree_map(lambda _: next(it), params)
            with spans.span(spans.FORWARD):
                loss, metrics = loss_for(tracked, batch)
            with spans.span(spans.BACKWARD):
                grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        it = iter(grads)
        return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
                tree_map(lambda _: next(it), params))

    return grad_fn


def make_train_step(
    cfg: ModelConfig,
    plan: ShardingPlan,
    mesh,
    opt: Optimizer,
    spec: Optional[TrainSpec] = None,
    param_shardings=None,
) -> Callable:
    """(params, opt_state, batch, step) -> (params, opt_state, metrics), with
    metrics ``loss``, ``tokens``, the MoE aux keys (one microbatch), and
    ``grad_norm`` and ``lr``, as in the reference.  ``param_shardings`` is
    accepted for the reference's signature and not used."""
    del param_shardings
    if spec is None:
        spec = TrainSpec()

    def loss_for(params, mb):
        return T.loss_fn(params, cfg, plan, mesh, mb, moe_opts=spec.moe_opts)

    grad_fn = value_and_grad(loss_for)
    if spec.compress_pod_grads and mesh is not None and "pod" in mesh.axis_names:
        from repro_torch.comm.protocols import wrap_grad_fn_with_pod_protocol
        grad_fn = wrap_grad_fn_with_pod_protocol(grad_fn, mesh, payload="int8")

    def step_body(params, opt_state, batch, step):
        dev = tree_leaves(params)[0].device
        batch = batch_to(batch, dev)
        nmb = spec.microbatches
        if nmb > 1:
            b = next(iter(batch.values())).shape[0]
            if b % nmb:
                raise ValueError(f"batch {b} does not split into {nmb} microbatches")
            mbs = [{k: v.reshape(nmb, b // nmb, *v.shape[1:])[i] for k, v in batch.items()}
                   for i in range(nmb)]
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=f32, device=p.device),
                             params)
            loss = torch.zeros((), dtype=f32, device=dev)
            for mb in mbs:
                (l_mb, _), g = grad_fn(params, mb)
                grads = tree_map(lambda acc, gi: acc + gi.to(f32) / nmb, grads, g)
                loss = loss + l_mb / nmb
            metrics = {"loss": loss}
        else:
            (loss, metrics), grads = grad_fn(params, batch)

        with spans.span(spans.CLIP):
            grads, gnorm = clip_by_global_norm(grads, spec.max_grad_norm)
        with spans.span(spans.LR):
            lr = lr_schedule(spec, torch.as_tensor(step, device=dev))
        with spans.span(spans.OPTIMIZER):
            params, opt_state = opt.update(grads, opt_state, params, lr)
        metrics = dict(metrics)
        metrics.update({"grad_norm": gnorm, "lr": lr})
        return params, opt_state, metrics

    def train_step(params, opt_state, batch, step):
        with spans.span(spans.STEP):
            return step_body(params, opt_state, batch, step)

    return train_step
