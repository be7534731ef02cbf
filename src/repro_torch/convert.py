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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core import archspec, binding, dse, dsl, search
from repro_torch.traces.base import Trace

__all__ = ["from_reference", "moe_tensors", "comm_problem", "run_comm_scenario"]

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
