"""Device meshes for the port.  A function, not a constant: importing this
module touches no device.

The port's counterpart of the JAX package's ``launch/mesh.py``.  A
:class:`Mesh` is named axes over a flat, row-major tuple of
``torch.device``s; :func:`shard_map` runs a rowwise body on each shard's
slice on that shard's device, in turn, and gathers the slices back, the
way ``shard_map`` runs a body per device with no collectives.  Also home of
:class:`MeshSpec`, the serializable description of how the DSE hot path
(stage-2 batched surrogate, stage-4 batched netsim) shards its candidate
axis, plus the pad/unpad helpers that make any batch size divisible by the
mesh extent.

How many devices a mesh may use: ``torch.cuda.device_count()`` cards, or
one CPU, unless the environment variable ``REPRO_TORCH_FORCE_DEVICE_COUNT``
says more (the counterpart of XLA's
``--xla_force_host_platform_device_count``).  Shard ``s`` lies on physical
device ``s % physical_count`` of the caller's device type, so with one card
and the variable at 8 all 8 shards are ``cuda:0`` and run one after
another.  A mesh never maps shards onto another device type than the
caller's, and never runs serially where it would not fit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import math
import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["compat_make_mesh", "make_production_mesh", "make_smoke_mesh",
           "plan_for_mesh", "device_count", "forced_device_count", "shard_map",
           "Mesh", "FORCE_ENV",
           "N_DEVICES", "MeshSpec", "padded_size", "shard_pad", "shard_unpad"]

N_DEVICES = {"single": 256, "multi": 512}

#: the environment variable that sets how many devices a mesh may use
FORCE_ENV = "REPRO_TORCH_FORCE_DEVICE_COUNT"


def _physical_count(device_type: str) -> int:
    if device_type == "cuda":
        return torch.cuda.device_count()
    if device_type == "cpu":
        return 1
    raise ValueError(f"unsupported device type {device_type!r}; use 'cuda' or 'cpu'")


def device_count(device_type: str = "cuda") -> int:
    """Devices a mesh of ``device_type`` may use: the physical count
    (``torch.cuda.device_count()``, or 1 CPU), unless ``FORCE_ENV`` is set,
    read at each call."""
    physical = _physical_count(device_type)
    forced = os.environ.get(FORCE_ENV, "").strip()
    if not forced:
        return physical
    try:
        n = int(forced)
    except ValueError:
        raise ValueError(f"{FORCE_ENV}={forced!r} is not an integer") from None
    if n < 1:
        raise ValueError(f"{FORCE_ENV}={n}; it must be >= 1")
    return n


@contextlib.contextmanager
def forced_device_count(n: int):
    """``FORCE_ENV`` set to ``n`` for the block, then restored (unset where
    it was unset): a caller that needs the production meshes' device count
    never leaves it set for the rest of the process."""
    prev = os.environ.get(FORCE_ENV)
    os.environ[FORCE_ENV] = str(n)
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(FORCE_ENV, None)
        else:
            os.environ[FORCE_ENV] = prev


def _validate_mesh_shape(shape, axes, device_type: str) -> None:
    """Raise (naming the numbers) instead of building a wrong-shaped mesh."""
    for extent, name in zip(shape, axes):
        if extent < 1:
            raise ValueError(
                f"mesh axis {name!r} has extent {extent}; every axis needs "
                f"extent >= 1 (shape={tuple(shape)})")
    needed = math.prod(shape)
    available = device_count(device_type)
    if needed > available:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {needed} devices but only "
            f"{available} are available (set {FORCE_ENV}={needed} to run "
            f"more shards than devices, each device taking its shards in turn)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over a flat, row-major tuple of devices (one per shard)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> extent, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def label(self) -> str:
        """``"2x4 data,model"``: the shape and axis names, as the JAX
        package's tracked sharded engines name their mesh."""
        return (f"{'x'.join(map(str, self.axis_sizes))} "
                f"{','.join(self.axis_names)}")

    def coords(self, shard: int) -> Tuple[int, ...]:
        """Shard index -> its index on each axis (row-major)."""
        return tuple(int(c) for c in np.unravel_index(shard, self.axis_sizes))

    def shard(self, coords: Sequence[int]) -> int:
        """Index on each axis -> the shard index (row-major)."""
        return int(np.ravel_multi_index(tuple(coords), self.axis_sizes))


#: (shape, axes, device type) -> Mesh: one object per layout per process
_MESH_CACHE: Dict[Tuple, Mesh] = {}


def compat_make_mesh(shape, axes, device=None) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``axes`` on ``device``'s type
    (default: CUDA, raising without a card).  Raises ``ValueError`` (with
    both numbers named) for zero-extent axes or shapes larger than
    :func:`device_count`, checked at every call."""
    from repro_torch.device import resolve_device
    dev_type = resolve_device(device).type
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    _validate_mesh_shape(shape, axes, dev_type)
    key = (shape, axes, dev_type)
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        physical = _physical_count(dev_type)
        if dev_type == "cpu":
            devices = (torch.device("cpu"),) * math.prod(shape)
        else:
            devices = tuple(torch.device("cuda", s % physical)
                            for s in range(math.prod(shape)))
        mesh = Mesh(axes, shape, devices)
        _MESH_CACHE[key] = mesh
    return mesh


def _on_device(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def shard_map(body: Callable, mesh: Mesh, in_axes: Sequence[Optional[int]],
              out_axes: Sequence[int]) -> Callable:
    """``body`` run shard by shard over ``mesh``, with no collectives.

    ``in_axes[i]`` is the candidate axis of positional argument i, split
    into ``mesh.size`` equal slices (shard s takes slice s), or None for an
    argument every shard gets whole (moved once to each distinct device).
    Each shard's call runs under its device; ``out_axes[j]`` is the axis
    along which output j's slices are concatenated on the device of the
    first split argument.  Keyword arguments pass through.  Bodies that are
    rowwise over the candidate axis give the unsplit call's result,
    bitwise."""
    in_axes, out_axes = tuple(in_axes), tuple(out_axes)
    k = mesh.size
    first = next((i for i, a in enumerate(in_axes) if a is not None), None)
    if first is None:
        raise ValueError("shard_map needs at least one split argument")

    def run(*args, **kwargs):
        if len(args) != len(in_axes):
            raise ValueError(f"shard_map body takes {len(in_axes)} positional "
                             f"arguments, got {len(args)}")
        for a, ax in zip(args, in_axes):
            if ax is not None and a.shape[ax] % k:
                raise ValueError(
                    f"an argument of {a.shape[ax]} rows along axis {ax} does "
                    f"not split into {k} shards; pad it with shard_pad")
        home = args[first].device
        whole: Dict[torch.device, list] = {}
        parts = [[] for _ in out_axes]
        for s, dev in enumerate(mesh.devices):
            if dev not in whole:
                whole[dev] = [a.to(dev) if ax is None else None
                              for a, ax in zip(args, in_axes)]
            shard_args = []
            for a, ax, rep in zip(args, in_axes, whole[dev]):
                if ax is None:
                    shard_args.append(rep)
                else:
                    n = a.shape[ax] // k
                    shard_args.append(a.narrow(ax, s * n, n).contiguous().to(dev))
            with _on_device(dev):
                out = body(*shard_args, **kwargs)
            out = out if isinstance(out, tuple) else (out,)
            if len(out) != len(out_axes):
                raise ValueError(f"shard_map body returned {len(out)} outputs, "
                                 f"out_axes names {len(out_axes)}")
            for j, o in enumerate(out):
                parts[j].append(o.to(home))
        outs = tuple(torch.cat(p, dim=ax) for p, ax in zip(parts, out_axes))
        return outs if len(outs) > 1 else outs[0]

    # the body's own signature, so a tracked wrapper keys calls by argument
    run.__signature__ = inspect.signature(body)
    return run


# --------------------------------------------------------------------------
# MeshSpec: serializable sharding request for the DSE hot path
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """How to shard the DSE candidate axis across the device mesh.

    ``devices`` is the candidate-axis extent (``--devices N`` on the CLI);
    ``scenario_axis`` is a second, data-parallel axis campaigns use to spread
    scenario groups.  The candidate batch is sharded over *both* axes (a
    campaign's concatenated per-scenario blocks land on different device
    groups), so the total shard count is ``devices * scenario_axis``.

    The spec is plain data — safe to serialize into scenario dicts and
    checkpoint manifests — and deliberately *not* part of ``SearchSpec``:
    search state is mesh-agnostic, which is what lets a checkpoint written
    on N devices resume bit-identically on M.
    """

    devices: int = 1
    scenario_axis: int = 1

    def __post_init__(self):
        if self.devices < 1:
            raise ValueError(
                f"MeshSpec candidate axis has size {self.devices}; "
                f"need >= 1 device")
        if self.scenario_axis < 1:
            raise ValueError(
                f"MeshSpec scenario axis has size {self.scenario_axis}; "
                f"need >= 1")

    @property
    def shard_axis(self) -> int:
        """Total candidate-axis shard count (both mesh axes combined)."""
        return self.devices * self.scenario_axis

    def is_single(self) -> bool:
        """True when this spec is the serial single-device path."""
        return self.shard_axis == 1

    def build(self, device=None) -> Mesh:
        """The (cached) Mesh on ``device``'s type: shape (scenario_axis,
        devices), axes ("scenario", "cand")."""
        return compat_make_mesh((self.scenario_axis, self.devices),
                                ("scenario", "cand"), device)

    def to_dict(self) -> dict:
        return {"devices": self.devices, "scenario_axis": self.scenario_axis}

    @classmethod
    def from_dict(cls, d: dict) -> "MeshSpec":
        return cls(devices=int(d.get("devices", 1)),
                   scenario_axis=int(d.get("scenario_axis", 1)))

    @classmethod
    def coerce(cls, value) -> Optional["MeshSpec"]:
        """None | int | dict | MeshSpec -> Optional[MeshSpec]."""
        if value is None or isinstance(value, cls):
            return value
        if isinstance(value, int):
            return cls(devices=value)
        if isinstance(value, dict):
            return cls.from_dict(value)
        raise TypeError(f"cannot build a MeshSpec from {value!r}")


def padded_size(n: int, k: int) -> int:
    """Smallest multiple of ``k`` that is >= ``n`` (>= ``k`` when n == 0)."""
    if k < 1:
        raise ValueError(f"shard count {k} must be >= 1")
    return k * max(1, -(-n // k))


def shard_pad(a: np.ndarray, k: int, axis: int = 0) -> np.ndarray:
    """Pad ``a`` along ``axis`` to a multiple of ``k`` by replicating row 0.

    Pad rows are throwaway duplicates of an existing candidate: every engine
    scan is rowwise-independent, so they cannot perturb real rows, and the
    host strips them with :func:`shard_unpad` before pricing — a padded run
    is bit-identical to the unpadded one."""
    n = a.shape[axis]
    pad = padded_size(n, k) - n
    if pad == 0:
        return a
    fill = np.repeat(np.take(a, [0], axis=axis), pad, axis=axis)
    return np.concatenate([np.asarray(a), fill], axis=axis)


def shard_unpad(a, n: int, axis: int = 0):
    """Strip pad rows: the first ``n`` entries of ``a`` along ``axis``."""
    index = (slice(None),) * axis + (slice(0, n),)
    return a[index]


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes, device)


def make_smoke_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    return compat_make_mesh((data, model), ("data", "model"), device)


def plan_for_mesh(mesh: Union[Mesh, None]):
    from repro_torch.models.config import MULTI_POD_PLAN, SINGLE_POD_PLAN
    return (MULTI_POD_PLAN if mesh is not None and "pod" in mesh.axis_names
            else SINGLE_POD_PLAN)
