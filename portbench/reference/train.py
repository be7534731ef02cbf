"""The reference's training steps: the configuration's loss (its family's
module), the gradient by autograd, clipping to a global norm, and AdamW,
in float32 with TF32 off (or, for the control, with fp8 operands).

``run`` starts from the initial leaves the benchmark made, takes the same
batches as the program's first steps, and gives what the comparison
reads: each step's loss, each leaf's norm of the first step's clipped
gradient, and each leaf's norm of the change after the last step.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from .common import Prec, adamw_leaf, clip_scale, gather, lr_at, tf32_off

__all__ = ["run", "family_module"]


def family_module(name: str):
    """The reference module a configuration file names (``reference``)."""
    return importlib.import_module(f"{__package__}.{name}")


def run(family: str, cfg: Dict, leaves0: Dict[str, torch.Tensor], decay: Dict[str, bool],
        batches: List[Dict[str, torch.Tensor]], hp: Dict, first_step: int,
        prec: Prec, sample: Dict[str, torch.Tensor]) -> Dict:
    """``len(batches)`` steps from ``leaves0`` (any dtype; taken to float32),
    numbered from ``first_step`` for the learning rate.  Returns
    {"losses": [...], "grad": {leaf: norm}, "change": {leaf: norm},
    "grad_sample": the first clipped gradient at ``sample``'s indices
    (``gather``), float32 on the host}."""
    model = family_module(family)
    names = list(leaves0)
    with tf32_off():
        params = {k: leaves0[k].float().clone().requires_grad_(True) for k in names}
        mu = {k: torch.zeros_like(params[k]) for k in names}
        nu = {k: torch.zeros_like(params[k]) for k in names}
        losses, grad_norms = [], {}
        for n, batch in enumerate(batches, start=1):
            loss = model.loss(params, cfg, batch, prec)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
            losses.append(float(loss.detach()))
            scale = clip_scale(grads, hp["max_grad_norm"])
            lr = lr_at(hp, first_step + n - 1)
            with torch.no_grad():
                if n == 1:
                    grad_sample = gather(dict(zip(names, grads)), sample, scale)
                for k, g in zip(names, grads):
                    g = g * scale
                    if n == 1:
                        grad_norms[k] = float(torch.linalg.vector_norm(g))
                    adamw_leaf(params[k], g, mu[k], nu[k], n, lr, hp, decay[k])
            del grads, loss
        with torch.no_grad():
            change = {k: float(torch.linalg.vector_norm(params[k] - leaves0[k].float()))
                      for k in names}
    return {"losses": losses, "grad": grad_norms, "change": change,
            "grad_sample": grad_sample}

