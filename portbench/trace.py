"""Reducing a ``torch.profiler`` trace of the measured window.

``Trace`` holds the device operations (kernels, copies, fills) and the
host operations that fall in the window that the driver marks with
``record_function(WINDOW)`` (annotations, on either side, are not
operations).  From them: the seconds in which some
operation ran on the device (the union of their intervals), each kernel's
summed time and launches by name, and the idle gaps between device
operations, each named by the innermost host operation under way when it
began.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

__all__ = ["WINDOW", "Trace", "short_name"]

#: the user annotation around the measured window
WINDOW = "portbench.window"
#: entries of each ``breakdown`` list
TOP = 10


def _ns(e, what: str) -> int:
    return int(getattr(e, f"{what}_ns")())


def _annotation(e) -> bool:
    """Whether a profiler event is a ``record_function`` mark (on the host
    or its copy on the device's timeline) rather than an operation."""
    return bool(e.is_user_annotation())


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its argument list, cut to ``width``."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"\(.*$", "", name).strip()
    return name[:width]


class Trace:
    """The window's operations, read from a finished profiler."""

    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        marks = [e for e in events if e.name() == WINDOW]
        if not marks:
            raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
        w = max(marks, key=lambda e: _ns(e, "duration"))
        self.t0, self.t1 = _ns(w, "start"), _ns(w, "end")
        self.device: List[Tuple[int, int, str]] = []
        self.host: List[Tuple[int, int, str]] = []
        for e in events:
            start, end = _ns(e, "start"), _ns(e, "end")
            if end <= self.t0 or start >= self.t1 or e is w:
                continue
            if _annotation(e):
                continue
            if "CUDA" in str(e.device_type()):
                self.device.append((start, end, e.name()))
            else:
                self.host.append((start, end, e.name()))
        self.device.sort()
        self.host.sort()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for start, end, _ in self.device:
            start, end = max(start, self.t0), min(end, self.t1)
            if out and start <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], end))
            else:
                out.append((start, end))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernels(self) -> Dict[str, Tuple[float, int]]:
        """name -> (summed seconds, launches) over the window."""
        acc: Dict[str, List] = defaultdict(lambda: [0.0, 0])
        for start, end, name in self.device:
            acc[name][0] += (end - start) * 1e-9
            acc[name][1] += 1
        return {k: (v[0], v[1]) for k, v in acc.items()}

    def top_device_ops(self) -> List[List]:
        acc: Dict[str, float] = defaultdict(float)
        for name, (sec, _) in self.kernels().items():
            acc[short_name(name)] += sec
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[List]:
        """The idle seconds between device operations, summed by what the
        host was doing when each gap began, largest first."""
        busy = self.busy_intervals()
        gaps, prev = [], self.t0
        for start, end in busy:
            if start > prev:
                gaps.append((prev, start))
            prev = end
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        acc: Dict[str, float] = defaultdict(float)
        j, open_ops = 0, []
        for g0, g1 in gaps:
            while j < len(self.host) and self.host[j][0] <= g0:
                open_ops.append(self.host[j])
                j += 1
            open_ops = [h for h in open_ops if h[1] > g0]
            label = max(open_ops, key=lambda h: h[0])[2] if open_ops else "host between operations"
            acc[short_name(label, 80)] += (g1 - g0) * 1e-9
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:TOP]]
