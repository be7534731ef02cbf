"""Pareto-front utilities for the DSE engine (Fig. 7 reproduction)."""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, TypeVar

import numpy as np

T = TypeVar("T")

__all__ = ["pareto_front", "is_dominated", "hypervolume_2d"]


def is_dominated(p: Sequence[float], q: Sequence[float]) -> bool:
    """True if q dominates p (q <= p everywhere, < somewhere). Minimisation."""
    p, q = np.asarray(p, float), np.asarray(q, float)
    return bool(np.all(q <= p) and np.any(q < p))


def pareto_front(items: Sequence[T], key: Callable[[T], Sequence[float]]) -> List[T]:
    """Return the non-dominated subset (all objectives minimised)."""
    pts = np.asarray([key(it) for it in items], dtype=float)
    n = len(items)
    keep = np.ones(n, dtype=bool)
    for i in range(n):
        if not keep[i]:
            continue
        for j in range(n):
            if i == j or not keep[j]:
                continue
            if is_dominated(pts[i], pts[j]):
                keep[i] = False
                break
    return [it for it, k in zip(items, keep) if k]


def hypervolume_2d(points: Sequence[Sequence[float]], ref: Sequence[float]) -> float:
    """2-D hypervolume (minimisation) w.r.t. reference point — DSE quality metric."""
    pts = sorted((float(a), float(b)) for a, b in points)
    rx, ry = float(ref[0]), float(ref[1])
    hv, prev_y = 0.0, ry
    for x, y in pts:
        if x >= rx or y >= prev_y:
            continue
        hv += (rx - x) * (prev_y - y)
        prev_y = y
    return hv
