"""Elastic re-meshing: resume a run on a different device count.

The port's counterpart of the JAX package's ``runtime/elastic.py``, over the
port's ``launch.mesh.Mesh``.  Checkpoints are mesh-agnostic (host arrays,
named-axis specs), so shrinking or growing the mesh is: validate the target
mesh, map every spec onto it, move every leaf.  The port keeps training
state whole on one device (its mesh shards the DSE candidate axis and the
MoE fabric, not parameters), so ``shardings_for`` maps a spec to the
device it lands on (the mesh's first) and ``remesh`` moves each leaf there,
bitwise.  Global batch is preserved by rescaling microbatches (same math,
new layout).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.launch.mesh import device_count
from repro_torch.train.optimizer import is_spec, tree_map

__all__ = ["remesh", "scaled_microbatches", "shardings_for"]


def shardings_for(mesh, specs):
    """The device each spec's leaf lives on over ``mesh`` (its first: the
    port does not split a leaf across devices).  Every axis a spec names
    must be one of the mesh's."""
    def one(spec):
        for entry in spec:
            for name in (entry if isinstance(entry, tuple) else (entry,)):
                if name is not None and name not in mesh.axis_names:
                    raise ValueError(f"spec {spec} names axis {name!r}, not one of "
                                     f"the mesh's {mesh.axis_names}")
        return mesh.devices[0]
    return tree_map(one, specs, is_leaf=is_spec)


def _validate_remesh_target(new_mesh) -> None:
    """Refuse meshes that would produce silently-wrong placements: a
    zero-extent axis, or more devices than the runtime has.  Both raise
    with the numbers named."""
    for name, extent in zip(new_mesh.axis_names, new_mesh.axis_sizes):
        if extent < 1:
            raise ValueError(
                f"remesh target axis {name!r} has extent {extent}; every "
                f"mesh axis needs extent >= 1 "
                f"(shape={tuple(new_mesh.axis_sizes)})")
    needed = len(new_mesh.devices)
    available = device_count(new_mesh.devices[0].type if new_mesh.devices else "cuda")
    if needed > available:
        raise ValueError(
            f"remesh target mesh needs {needed} devices but only "
            f"{available} are available")


def remesh(state: Any, specs: Any, new_mesh) -> Any:
    """Move a (host or device) state tree onto a new mesh, bitwise."""
    _validate_remesh_target(new_mesh)
    placements = shardings_for(new_mesh, specs)

    def move(leaf, dev):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
        return t.detach().to(dev, copy=True)
    return tree_map(move, state, placements)


def scaled_microbatches(old_microbatches: int, old_dp: int, new_dp: int) -> int:
    """Keep the global batch fixed when the data-parallel extent changes."""
    scaled = old_microbatches * old_dp
    assert scaled % new_dp == 0, (old_microbatches, old_dp, new_dp)
    return max(1, scaled // new_dp)
