"""Carry the JAX package's state across to the port, without importing it.

``from_reference(obj)`` rebuilds a reference ``Trace``, ``SwitchArch``,
``ArchRequest``, ``BoundProtocol``, ``SLA`` or ``ResourceBudget`` (and the
pieces they hold: protocols, fields, parser plans, policies) as the port's
own type, from its fields and NumPy arrays.  It is duck-typed on the class
name, so it accepts the reference's objects while ``repro`` stays out of this
package's imports.  ``Trace.save``/``load`` keep the reference's ``.npz``
format, so a saved trace loads in either package.  (A scenario crosses over
as its dict: ``repro_torch.api.Scenario.from_dict(scenario.to_dict())``.)

The comm domain's tensors cross as NumPy arrays: ``moe_tensors`` turns the
reference's ``init_moe`` parameters and routing sample (bfloat16 carried as
its uint16 bit pattern) into the port's tensors, and ``comm_problem`` /
``run_comm_scenario`` build a comm scenario's problem, or run it, with them
in place of the port's own seeded draws (which cannot give the reference's
``jax.random`` bits).

The model's weights cross the same way: ``seeded_model_arrays(cfg, seed)``
draws a whole model's parameters (the reference's ``init_params`` tree,
flattened to ``"layers.attn.wq"``-style names, layers stacked on a leading
L dimension, bfloat16 as uint16) from NumPy's ``default_rng(seed)`` with the
reference's initializers' distributions, at any width; ``model_params``
turns such arrays into the port's parameter tree.  Both packages can be fed
the same arrays, so parity at full width needs no stored weights.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core import archspec, binding, dse, dsl, search
from repro_torch.traces.base import Trace

__all__ = ["from_reference", "moe_tensors", "comm_problem", "run_comm_scenario",
           "seeded_model_arrays", "model_params", "opt_state"]

_ENUMS = {cls.__name__: cls for cls in (archspec.ForwardTableKind,
                                         archspec.VOQKind,
                                         archspec.SchedulerKind)}
_DATACLASSES = {cls.__name__: cls for cls in (
    Trace, archspec.SwitchArch, archspec.ArchRequest, archspec.CustomKernelSpec,
    binding.BoundProtocol, binding.SemanticBinding, dsl.Field, dsl.FieldSpec,
    dsl.FieldSlice, dsl.ParserPlan, dse.SLA, dse.ResourceBudget,
    search.SearchSpec)}


def from_reference(obj: Any) -> Any:
    """The port's equivalent of a reference object (see the module note).

    Plain values, NumPy arrays and callables pass through; containers are
    converted element by element.  Raises ``TypeError`` for a type the
    port has no counterpart for."""
    if obj is None or isinstance(obj, (bool, int, float, str, np.ndarray,
                                       np.generic)):
        return obj
    name = type(obj).__name__
    if name == "_Auto":
        return archspec.AUTO
    if name in _ENUMS:
        return _ENUMS[name](obj.value)
    if isinstance(obj, (list, tuple)):
        return type(obj)(from_reference(x) for x in obj)
    if isinstance(obj, dict):
        return {k: from_reference(v) for k, v in obj.items()}
    if name == "Protocol":
        return dsl.Protocol(obj.name, [from_reference(f) for f in obj.fields])
    if name in _DATACLASSES and dataclasses.is_dataclass(obj):
        cls = _DATACLASSES[name]
        return cls(**{f.name: from_reference(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.init})
    if callable(obj):
        return obj
    raise TypeError(f"no repro_torch counterpart for {type(obj).__module__}."
                    f"{type(obj).__qualname__}")


# --------------------------------------------------------------------------
# the comm domain's tensors
# --------------------------------------------------------------------------

def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                           # an owned, writable copy
    if a.dtype.name == "bfloat16":            # NumPy's bfloat16 (ml_dtypes)
        a = a.view(np.uint16)
    if a.dtype == np.uint16:                  # a bfloat16 bit pattern
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def moe_tensors(arrays: Mapping[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """NumPy arrays -> tensors on ``device`` (default: the first CUDA
    device).  uint16 arrays (and NumPy bfloat16 ones) are bfloat16 bit
    patterns; every other dtype maps to its torch twin."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in arrays.items()}


def comm_problem(scenario, arrays: Mapping[str, np.ndarray], device=None):
    """The comm scenario's ``CommDSEProblem`` with ``arrays`` (any of
    ``router``, ``hash_proj``, ``w1``, ``wg``, ``w2`` and the routing sample
    ``x``; other keys are ignored) in place of the port's seeded draws."""
    from repro_torch.api.runner import _build_comm_problem
    names = ("router", "hash_proj", "w1", "wg", "w2", "x")
    return _build_comm_problem(
        scenario, device,
        moe_tensors({k: v for k, v in arrays.items() if k in names}, device))


def run_comm_scenario(scenario, arrays: Mapping[str, np.ndarray], device=None,
                      **kw):
    """``run_scenario`` on the comm scenario with ``comm_problem``'s problem."""
    from repro_torch.api.runner import run_scenario
    return run_scenario(scenario, device=device,
                        problem=comm_problem(scenario, arrays, device), **kw)


# --------------------------------------------------------------------------
# the model's weights
# --------------------------------------------------------------------------

#: elements of one NumPy draw; each draw has its own seed (the model's seed,
#: the leaf's index, the draw's index)
_DRAW_ELEMS = 1 << 23


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), rounded to nearest even."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16).astype(np.uint16)


def _leaves(cfg) -> Iterator[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, kind, scale) for each parameter of ``init_params``, in
    a fixed order.  kind: "bf16"/"f32" normal draws times ``scale``, or
    "ones"/"zeros"."""
    d, n_l = cfg.d_model, cfg.n_layers
    if cfg.frontend == "tokens":
        yield "embed", (cfg.vocab, d), "bf16", d ** -0.5
    yield "unembed", (d, cfg.vocab), "bf16", d ** -0.5
    yield "final_norm", (d,), "ones", 0.0
    yield "layers.ln1", (n_l, d), "ones", 0.0
    if cfg.has_attention:
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        for w, cols in (("wq", hq * hd), ("wk", hkv * hd), ("wv", hkv * hd)):
            yield f"layers.attn.{w}", (n_l, d, cols), "bf16", d ** -0.5
        yield "layers.attn.wo", (n_l, hq * hd, d), "bf16", (hq * hd) ** -0.5
    if cfg.has_ssm:
        di, n, h = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
        yield "layers.ssm.wz", (n_l, d, di), "bf16", d ** -0.5
        yield "layers.ssm.wx", (n_l, d, di), "bf16", d ** -0.5
        yield "layers.ssm.wb", (n_l, d, n), "bf16", d ** -0.5
        yield "layers.ssm.wc", (n_l, d, n), "bf16", d ** -0.5
        yield "layers.ssm.wdt", (n_l, d, h), "f32", d ** -0.5
        yield "layers.ssm.conv_w", (n_l, di, cfg.ssm_conv), "f32", 0.1
        yield "layers.ssm.a_log", (n_l, h), "zeros", 0.0
        yield "layers.ssm.dskip", (n_l, h), "ones", 0.0
        yield "layers.ssm.dt_bias", (n_l, h), "zeros", 0.0
        yield "layers.ssm.norm_g", (n_l, di), "ones", 0.0
        yield "layers.ssm.wo", (n_l, di, d), "bf16", di ** -0.5
    if cfg.family == "ssm":
        return
    yield "layers.ln2", (n_l, d), "ones", 0.0
    ff = cfg.d_ff
    if cfg.is_moe:
        e = cfg.moe_experts
        yield "layers.moe.router", (n_l, d, e), "f32", d ** -0.5
        yield "layers.moe.hash_proj", (n_l, d, 32), "f32", 1.0
        yield "layers.moe.w1", (n_l, e, d, ff), "bf16", d ** -0.5
        yield "layers.moe.wg", (n_l, e, d, ff), "bf16", d ** -0.5
        yield "layers.moe.w2", (n_l, e, ff, d), "bf16", ff ** -0.5
    else:
        yield "layers.mlp.wi", (n_l, d, ff), "bf16", d ** -0.5
        yield "layers.mlp.wg", (n_l, d, ff), "bf16", d ** -0.5
        yield "layers.mlp.wo", (n_l, ff, d), "bf16", ff ** -0.5


def _draw(seed, leaf, part, n, scale, bf16) -> np.ndarray:
    x = np.random.default_rng([seed, leaf, part]).standard_normal(n, dtype=np.float32)
    x *= np.float32(scale)
    return _bf16_bits(x) if bf16 else x


def seeded_model_arrays(cfg, seed: int) -> Dict[str, np.ndarray]:
    """A model's parameters drawn with NumPy from ``seed``: N(0, 1/fan_in)
    weights (drawn in float32, scaled in float32, bfloat16 ones rounded to
    nearest even and kept as uint16 bits), the LSH projection N(0, 1),
    ``conv_w`` N(0, 1) * 0.1, and the reference's constant leaves.  Each
    block of 2**23 elements is drawn from ``default_rng([seed, leaf,
    block])``, so the arrays depend on the shapes and the seed only."""
    out: Dict[str, np.ndarray] = {}
    jobs = []
    for leaf, (name, shape, kind, scale) in enumerate(_leaves(cfg)):
        if kind in ("ones", "zeros"):
            out[name] = (np.ones if kind == "ones" else np.zeros)(shape, np.float32)
            continue
        size = int(np.prod(shape))
        flat = np.empty(size, np.uint16 if kind == "bf16" else np.float32)
        for part, lo in enumerate(range(0, size, _DRAW_ELEMS)):
            jobs.append((flat, leaf, part, lo, min(_DRAW_ELEMS, size - lo), scale,
                         kind == "bf16"))
        out[name] = flat.reshape(shape)

    def fill(job):
        flat, leaf, part, lo, n, scale, bf16 = job
        flat[lo:lo + n] = _draw(seed, leaf, part, n, scale, bf16)

    # each block has its own seed, so the blocks are drawn in any order:
    # in threads (NumPy's generators release the GIL while they fill)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for done in pool.map(fill, jobs):
            del done
    return out


def model_params(arrays: Mapping[str, np.ndarray], device=None) -> Dict[str, Any]:
    """Flat ``seeded_model_arrays``-style arrays (or the reference's
    ``init_params`` tree flattened the same way) -> the port's parameter
    tree on ``device`` (default: the first CUDA device).  uint16 arrays
    (and NumPy bfloat16 ones) are bfloat16 bit patterns."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    tree: Dict[str, Any] = {}
    for name, a in arrays.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = _tensor(a, dev)
    return tree


def opt_state(tree: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """An optimizer state as nested dicts of NumPy arrays (the reference's
    AdamW ``{"mu", "nu", "count"}`` or Adafactor ``{"v", "count"}``, read
    with ``np.asarray`` leaf by leaf) -> the same tree of tensors on
    ``device`` (default: the first CUDA device), dtypes kept (uint16 and
    NumPy bfloat16 arrays as bfloat16, ``count`` an int32 scalar), so that
    both packages can start from one state."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        return _tensor(np.asarray(x), dev)
    return conv(tree)

