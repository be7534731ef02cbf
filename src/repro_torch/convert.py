"""Carry the JAX package's state across to the port, without importing it.

``from_reference(obj)`` rebuilds a reference ``Trace``, ``SwitchArch``,
``ArchRequest``, ``BoundProtocol``, ``SLA`` or ``ResourceBudget`` (and the
pieces they hold: protocols, fields, parser plans, policies) as the port's
own type, from its fields and NumPy arrays.  It is duck-typed on the class
name, so it accepts the reference's objects while ``repro`` stays out of this
package's imports.  ``Trace.save``/``load`` keep the reference's ``.npz``
format, so a saved trace loads in either package.  (A scenario crosses over
as its dict: ``repro_torch.api.Scenario.from_dict(scenario.to_dict())``.)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core import archspec, binding, dse, dsl, search
from repro_torch.traces.base import Trace

__all__ = ["from_reference"]

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
