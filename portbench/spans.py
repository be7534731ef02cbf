"""Charging a traced window's device time to the program's spans.

The program marks its training step with ``record_function`` spans, each
named ``repro_torch.<span>``: ``train.step``, ``train.forward``,
``train.backward``, ``model.block`` (``model.block.recompute`` when remat
runs it again inside the backward), ``model.loss``, ``train.clip``,
``train.lr`` and ``train.optimizer``.  ``charge`` reads a finished
profiler's events and charges every device operation that ``Trace`` counts
in the window to one ``span/phase``:

- the operation's launch is the CUDA runtime or driver call with its
  correlation id, which gives a thread and a time;
- the innermost event on that thread that holds the launch, among the spans
  and the autograd engine's ``evaluate_function`` nodes, decides: a span is
  charged itself, phase ``fwd`` (``recompute`` for ``model.block.recompute``);
  a node's sequence number and forward thread name the forward operation
  that made it, and the node is charged to that operation's innermost span,
  phase ``bwd``;
- ``(none)`` where no span holds the launch or the node's forward
  operation, ``(no launch)`` where the trace holds no launch.

The same pass counts the blocking runtime calls (``SYNCS``) made inside
``train.step``, by the innermost span of the calling thread, and charges
each idle gap that ``Trace`` finds to the innermost span open on the step's
thread when the gap began, and sums the backward by autograd node.
``metrics`` gives six numbers a step from that.

``python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>``
runs the cell as ``run.py --trace 1`` does and prints run.py's line, then
one more JSON line: the six numbers and the charges.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.trace import TOP, Trace

__all__ = ["PREFIX", "NONE", "NO_LAUNCH", "NODE", "SYNCS", "Charges", "innermost",
           "charge", "metrics", "main"]

PREFIX = "repro_torch."
STEP, BACKWARD = "train.step", "train.backward"
BLOCK, RECOMPUTE, LOSS = "model.block", "model.block.recompute", "model.loss"
OPTIMIZER = ("train.clip", "train.lr", "train.optimizer")
NONE, NO_LAUNCH = "(none)", "(no launch)"
#: the autograd engine's event around one node of the backward graph
NODE = "autograd::engine::evaluate_function: "
#: runtime calls that make the host wait for the device
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")
#: where the backward's device time belongs: the layers' own passes
LAYERS = (f"{BLOCK}/bwd", f"{RECOMPUTE}/recompute", f"{LOSS}/bwd")


@dataclasses.dataclass
class Charges:
    """One window's charges: device seconds by ``span/phase``, and the
    backward's by autograd node (``MulBackward0``); idle seconds by span;
    blocking calls inside ``train.step`` by span; the steps begun in the
    window; all device seconds; the device seconds launched inside
    ``train.backward`` and, of them, those charged to ``LAYERS``."""

    spans: Dict[str, float]
    nodes: Dict[str, float]
    idle_by_span: Dict[str, float]
    syncs: Dict[str, int]
    steps: int
    device_s: float
    bwd_s: float
    bwd_layers_s: float


def innermost(intervals: Sequence[Tuple[int, int, object]], times: Sequence[int]) -> List:
    """For each time, the payload of the innermost interval holding it
    (start <= t < end), or None; the intervals nest as scopes do."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out: List = [None] * len(times)
    stack: List = []
    j = 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while j < len(ivs) and ivs[j][0] <= t:
            while stack and stack[-1][1] <= ivs[j][0]:
                stack.pop()
            stack.append(ivs[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[k] = stack[-1][2] if stack else None
    return out


def _on_threads(intervals: Dict[int, List], queries: Dict) -> Dict:
    """``innermost`` thread by thread: {thread: intervals} and {key:
    (thread, time)} -> {key: payload}."""
    by_tid: Dict[int, List] = defaultdict(list)
    for key, (tid, t) in queries.items():
        by_tid[tid].append((t, key))
    out = {}
    for tid, qs in by_tid.items():
        found = innermost(intervals.get(tid, []), [t for t, _ in qs])
        out.update((key, p) for (_, key), p in zip(qs, found))
    return out


def charge(prof, trace: Optional[Trace] = None) -> Charges:
    """The window's charges, from a finished ``torch.profiler.profile``
    (``trace``: its ``Trace``, if made already)."""
    tr = trace or Trace(prof)
    spans: Dict[int, List] = defaultdict(list)       # thread -> (start, end, span)
    scopes: Dict[int, List] = defaultdict(list)      # the same and the nodes
    fwd_ops: Dict[Tuple[int, int], int] = {}         # (sequence nr, thread) -> start
    launches: Dict[int, Tuple[int, int]] = {}        # correlation id -> (thread, start)
    syncs: List[Tuple[int, int]] = []                # (thread, start)
    devs: List[Tuple[int, int]] = []                 # (correlation id, ns)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, end = int(e.start_ns()), int(e.end_ns())
        if "CUDA" in str(e.device_type()):
            if not e.is_user_annotation() and end > tr.t0 and start < tr.t1:
                devs.append((e.correlation_id(), end - start))
            continue
        tid = e.start_thread_id()
        if e.is_user_annotation():
            if name.startswith(PREFIX):
                iv = (start, end, name[len(PREFIX):])
                spans[tid].append(iv)
                scopes[tid].append(iv)
        elif name.startswith(NODE):
            node = (e.sequence_nr(), e.fwd_thread_id(), name[len(NODE):])
            scopes[tid].append((start, end, node))
        elif name.startswith("cu"):
            launches[e.correlation_id()] = (tid, start)
            if name in SYNCS:
                syncs.append((tid, start))
        elif e.sequence_nr() >= 0 and not e.fwd_thread_id():
            # ops that make no node record the number the next node takes:
            # the node's maker is the last op to record it
            key = (e.sequence_nr(), tid)
            fwd_ops[key] = max(start, fwd_ops.get(key, start))

    op_span = _on_threads(spans, {key: (key[1], t) for key, t in fwd_ops.items()})
    launched = {c: launches[c] for c, _ in devs if c in launches}
    where = _on_threads(scopes, launched)
    every = [iv for ivs in spans.values() for iv in ivs]
    backward = [iv for iv in every if iv[2] == BACKWARD]
    in_bwd = dict(zip(launched, innermost(backward, [t for _, t in launched.values()])))

    charged: Dict[str, float] = defaultdict(float)
    by_node: Dict[str, float] = defaultdict(float)
    bwd_s = bwd_layers_s = 0.0
    for c, ns in devs:
        sec = ns * 1e-9
        p = where.get(c)
        if c not in launched:
            key = NO_LAUNCH
        elif isinstance(p, tuple):
            key = f"{op_span.get(p[:2]) or NONE}/bwd"
            by_node[p[2]] += sec
        else:
            key = f"{p or NONE}/{'recompute' if p == RECOMPUTE else 'fwd'}"
        charged[key] += sec
        if in_bwd.get(c) is not None:
            bwd_s += sec
            bwd_layers_s += sec if key in LAYERS else 0.0

    steps = [iv for iv in every if iv[2] == STEP and tr.t0 <= iv[0] < tr.t1]
    step_tid = next((t for t, ivs in spans.items() if any(iv[2] == STEP for iv in ivs)), None)
    # the idle gaps as Trace finds them, by the span open on the step's thread
    gaps, prev = [], tr.t0
    for start, end in tr.busy_intervals():
        if start > prev:
            gaps.append((prev, start))
        prev = end
    if tr.t1 > prev:
        gaps.append((prev, tr.t1))
    idle: Dict[str, float] = defaultdict(float)
    for (g0, g1), span in zip(gaps, innermost(spans.get(step_tid, []), [g for g, _ in gaps])):
        idle[span or NONE] += (g1 - g0) * 1e-9

    in_step = innermost(steps, [t for _, t in syncs])
    inside = {i: at for i, (at, s) in enumerate(zip(syncs, in_step)) if s is not None}
    counts: Dict[str, int] = defaultdict(int)
    for span in _on_threads(spans, inside).values():
        counts[span or NONE] += 1
    return Charges(spans=dict(charged), nodes=dict(by_node), idle_by_span=dict(idle),
                   syncs=dict(counts), steps=len(steps),
                   device_s=sum(ns for _, ns in devs) * 1e-9, bwd_s=bwd_s,
                   bwd_layers_s=bwd_layers_s)


def metrics(ch: Charges) -> Dict[str, float]:
    """The six numbers a step; empty where the window holds no
    ``train.step`` span, and without a number whose spans are absent."""
    if ch.steps <= 0:
        return {}
    parts = {
        "block_fwd_ms_per_step": [f"{BLOCK}/fwd"],
        "block_recompute_ms_per_step": [f"{RECOMPUTE}/recompute"],
        "block_bwd_ms_per_step": [f"{BLOCK}/bwd"],
        "loss_ms_per_step": [f"{LOSS}/fwd", f"{LOSS}/bwd"],
        "optimizer_ms_per_step": [k for k in ch.spans if k.split("/")[0] in OPTIMIZER],
    }
    out = {name: 1e3 * sum(ch.spans[k] for k in keys if k in ch.spans) / ch.steps
           for name, keys in parts.items() if any(k in ch.spans for k in keys)}
    out["host_syncs_per_step"] = sum(ch.syncs.values()) / ch.steps
    return out


def _largest_first(d: Dict[str, float]) -> List[List]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])]


def main(argv=None) -> int:
    """``run.py --trace 1`` with the charges of its window printed after."""
    from portbench import run
    from portbench.drivers import train as driver

    found = []

    class Charged(Trace):
        def __init__(self, prof):
            super().__init__(prof)
            found.append((charge(prof, self), sum(s for s, _ in self.kernels().values())))

    driver.Trace = Charged        # run.py reads the driver's Trace; this one also charges
    rc = run.main(list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"])
    if rc or not found:
        return rc or 1
    ch, kernels_s = found[-1]
    print(json.dumps({"metrics": metrics(ch), "steps": ch.steps, "device_s": ch.device_s,
                      "kernels_s": kernels_s, "bwd_s": ch.bwd_s,
                      "bwd_layers_s": ch.bwd_layers_s, "syncs": ch.syncs,
                      "spans": _largest_first(ch.spans),
                      "nodes": _largest_first(ch.nodes)[:TOP],
                      "idle_by_span": _largest_first(ch.idle_by_span)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
