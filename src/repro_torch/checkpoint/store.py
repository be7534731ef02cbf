"""Checkpointing: mesh-agnostic save/restore with async snapshots.

Layout:  <dir>/step_<N>/
           manifest.json     — step, leaf count, shapes/dtypes, metadata
           <idx>.npy         — one file per leaf (copied to the host)

The on-disk format is the JAX package's (``repro.checkpoint.store``) byte
for byte, so a checkpoint either package writes restores in the other:
leaves are numbered in ``jax.tree.flatten``'s order (dict keys sorted,
lists and tuples in order, ``None`` a node with no leaf), a leaf dtype NumPy
cannot save (bfloat16, the float8s) is written as its ``uint8`` bytes with
its dtype's name in the manifest, and a step is published by one atomic
rename of its ``.tmp`` directory.  NumPy has no bfloat16: such a leaf comes
back as a ``torch.bfloat16`` tensor, bit for bit.

Arrays are saved whole on the host, which makes checkpoints *mesh-agnostic*.
``AsyncCheckpointer`` copies every leaf to host memory synchronously (a
device tensor is read only on the caller's thread) and writes to disk on a
background thread, so a long run never blocks on IO.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]

_NATIVE = set("?bhilqBHILQefdgFDG")  # numpy kind chars that np.save round-trips

#: dtypes NumPy cannot hold, by the name the manifest records
_TORCH_ONLY = {"bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn,
               "float8_e5m2": torch.float8_e5m2}


# --------------------------------------------------------------------------
# jax.tree.flatten's order, without jax
# --------------------------------------------------------------------------

class _Node:
    """A tree's structure: ``kind`` is "leaf", "none", "dict", "odict",
    "list", "tuple" or "namedtuple"; ``keys`` the dict keys in flatten
    order; ``ctor`` a namedtuple's class."""

    __slots__ = ("kind", "keys", "children", "ctor")

    def __init__(self, kind, keys=None, children=(), ctor=None):
        self.kind, self.keys, self.children, self.ctor = kind, keys, children, ctor


def _flatten(tree) -> Tuple[List[Any], _Node]:
    leaves: List[Any] = []

    def walk(x) -> _Node:
        if x is None:
            return _Node("none")
        if type(x) is dict:
            return _Node("dict", sorted(x), [walk(x[k]) for k in sorted(x)])
        if type(x) is OrderedDict:              # jax keeps its own order
            return _Node("odict", list(x), [walk(v) for v in x.values()])
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return _Node("namedtuple", None, [walk(v) for v in x], type(x))
        if type(x) in (list, tuple):
            return _Node(type(x).__name__, None, [walk(v) for v in x])
        leaves.append(x)
        return _Node("leaf")

    return leaves, walk(tree)


def _unflatten(node: _Node, leaves: List[Any]):
    it = iter(leaves)

    def build(n: _Node):
        if n.kind == "leaf":
            return next(it)
        if n.kind == "none":
            return None
        kids = [build(c) for c in n.children]
        if n.kind == "dict":
            return dict(zip(n.keys, kids))
        if n.kind == "odict":
            return OrderedDict(zip(n.keys, kids))
        if n.kind == "namedtuple":
            return n.ctor(*kids)
        return list(kids) if n.kind == "list" else tuple(kids)

    return build(node)


# --------------------------------------------------------------------------
# leaves <-> disk
# --------------------------------------------------------------------------

def _host(leaf):
    """A leaf as a host value: a tensor becomes a CPU copy (never a view of
    memory the caller may go on writing), anything else a NumPy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _dtype_name(a) -> str:
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return str(a.dtype)


def _to_disk(a) -> np.ndarray:
    """The array ``np.save`` writes for a host leaf: itself where NumPy
    holds its dtype, else its bytes (``uint8``, the last axis widened by the
    item size, as the JAX package writes a bfloat16 leaf)."""
    if isinstance(a, torch.Tensor):
        if a.dtype in _TORCH_ONLY.values():
            t = a.contiguous()
            return t.reshape(1).view(torch.uint8).numpy() if t.dim() == 0 \
                else t.view(torch.uint8).numpy()
        return a.numpy()
    if a.dtype.char in _NATIVE or a.dtype.kind in "iufb":
        return a
    return np.ascontiguousarray(a).view(np.uint8)


def _from_disk(arr: np.ndarray, dtype_str: str, shape):
    torch_dtype = _TORCH_ONLY.get(dtype_str)
    if torch_dtype is not None:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint8))
        return t.view(torch_dtype).reshape(tuple(shape))
    dt = np.dtype(dtype_str)
    if arr.dtype == dt:
        return arr
    return arr.view(dt)


def save(ckpt_dir: str, step: int, tree, *, extra: Optional[Dict] = None) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    leaves, _ = _flatten(tree)
    host = [_host(leaf) for leaf in leaves]
    for i, arr in enumerate(host):
        np.save(os.path.join(tmp, f"{i}.npy"), _to_disk(arr))
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "shapes": [list(a.shape) for a in host],
        "dtypes": [_dtype_name(a) for a in host],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)                      # atomic publish
    return path


def _step_of(entry: str) -> Optional[int]:
    """``step_<N>`` -> N; None for tmp dirs and stray non-step entries
    (editor droppings, ``step_backup`` copies, ...) instead of ValueError."""
    if not entry.startswith("step_") or entry.endswith(".tmp"):
        return None
    try:
        return int(entry.split("_", 1)[1])
    except ValueError:
        return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for s in map(_step_of, os.listdir(ckpt_dir)) if s is not None]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None, *, template=None,
            device=None) -> Tuple[Any, Dict]:
    """Restore a tree shaped like ``template``.  A leaf whose template leaf
    is a tensor comes back as a tensor on ``device`` (default: the template
    leaf's device); a bfloat16 or float8 leaf as a CPU tensor otherwise;
    every other leaf as a NumPy array."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = [_from_disk(np.load(os.path.join(path, f"{i}.npy")), dt, shape)
              for i, dt, shape in zip(range(manifest["n_leaves"]),
                                      manifest["dtypes"], manifest["shapes"])]
    if template is None:
        raise ValueError("restore() requires a template tree for structure")
    like, treedef = _flatten(template)
    if len(like) != len(leaves):
        raise ValueError(f"checkpoint step {step} holds {len(leaves)} leaves, "
                         f"the template {len(like)}")
    out = []
    for leaf, tmpl in zip(leaves, like):
        if isinstance(tmpl, torch.Tensor):
            t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(leaf)
            leaf = t.to(device if device is not None else tmpl.device)
        out.append(leaf)
    return _unflatten(treedef, out), manifest


class AsyncCheckpointer:
    """Snapshot-to-host now, write-to-disk in the background."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = None
        self._lock = threading.Lock()

    def save_async(self, step: int, tree, *, extra: Optional[Dict] = None):
        leaves, treedef = _flatten(tree)
        host = _unflatten(treedef, [_host(leaf) for leaf in leaves])
        self.wait()
        self._pending = self._pool.submit(self._write, step, host, extra)

    def _write(self, step, host_tree, extra):
        save(self.ckpt_dir, step, host_tree, extra=extra)
        self._gc()

    def _gc(self):
        steps = sorted(s for s in map(_step_of, os.listdir(self.ckpt_dir))
                       if s is not None)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        with self._lock:
            if self._pending is not None:
                self._pending.result()
                self._pending = None
