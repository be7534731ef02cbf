"""Seeded weights, made by the benchmark on the device in a few large calls.

The layout (each leaf's path, shape and dtype) is the program's parameter
tree; the values are the benchmark's, drawn from ``--seed`` and handed to
the program and to the reference alike.  Every leaf drawn from a normal
distribution is a slice of one ``randn`` per dtype, every uniform one a
slice of one ``rand``, so the same seed gives the same weights on any
call, and the whole tree is made again (for the reference, or for the
change after the first steps) by calling ``make`` once more.

Every leaf's rule is named by the leaf's last name in the configuration
file's ``init`` block (leaves under ``layers`` are stacked on a leading
layer dimension, as the program keeps them, and share their rule):

  ``ones``                      filled with ones
  ``normal:<std>``              N(0, std^2)
  ``log_uniform:<lo>:<hi>``     log of U[lo, hi]
  ``inv_softplus_log_uniform:<lo>:<hi>``
                                softplus^-1 of exp(U[log lo, log hi])
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["derive_seed", "make", "Layout"]

#: leaf path -> (shape, dtype)
Layout = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
#: slices start on multiples of this many elements (aligned rows for TMA)
_ALIGN = 64


def derive_seed(seed: int, *stream: int) -> int:
    """A 63-bit generator seed for one stream of ``seed``'s draws."""
    return int(np.random.SeedSequence([seed, *stream]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def _rule(name: str, rules: Dict[str, str]) -> str:
    rule = rules.get(name.rsplit(".", 1)[-1])
    if rule is None:
        raise ValueError(f"leaf {name}: no rule in the configuration's init block")
    return rule


def make(layout: Layout, rules: Dict[str, str], seed: int, device) -> Dict[str, torch.Tensor]:
    """The leaves of ``layout`` drawn from ``seed`` on ``device``."""
    plan = {name: _rule(name, rules) for name in layout}
    normal = [n for n, r in plan.items() if r.startswith("normal:")]
    uniform = [n for n, r in plan.items() if "uniform:" in r]
    out: Dict[str, torch.Tensor] = {}
    for kind, names in (("normal", normal), ("uniform", uniform)):
        for k, dtype in enumerate(sorted({layout[n][1] for n in names}, key=str)):
            group = [n for n in names if layout[n][1] == dtype]
            offsets, total = {}, 0
            for n in group:
                offsets[n] = total
                total += -(-math.prod(layout[n][0]) // _ALIGN) * _ALIGN
            gen = torch.Generator(device=device).manual_seed(
                derive_seed(seed, 0 if kind == "normal" else 1, k))
            draw = torch.randn if kind == "normal" else torch.rand
            buf = draw(total, generator=gen, dtype=dtype, device=device)
            for n in group:
                shape = layout[n][0]
                out[n] = _shape(buf[offsets[n]:offsets[n] + math.prod(shape)].view(shape),
                                plan[n])
    for n, r in plan.items():
        if r == "ones":
            shape, dtype = layout[n]
            out[n] = torch.ones(shape, dtype=dtype, device=device)
    return {n: out[n] for n in layout}


def _shape(t: torch.Tensor, rule: str) -> torch.Tensor:
    """Bring a slice of the standard draw to its rule's distribution, in place."""
    kind, *args = rule.split(":")
    if kind == "normal":
        return t.mul_(float(args[0]))
    lo, hi = float(args[0]), float(args[1])
    if kind == "log_uniform":
        return t.mul_(hi - lo).add_(lo).log_()
    if kind == "inv_softplus_log_uniform":
        dt = t.mul_(math.log(hi) - math.log(lo)).add_(math.log(lo)).exp_()
        return dt.add_(torch.log(-torch.expm1(-dt)))
    raise ValueError(f"unknown init rule {rule!r}")
