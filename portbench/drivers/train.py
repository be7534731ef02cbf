"""The training driver: the port's training step on one device, its first
steps checked against the plain reference, then a measured window.

Set-up builds one program object (``Program``): the configuration as the
port's ``ModelConfig``, its ``make_train_step`` with ``adamw`` (one
microbatch, the configuration's bf16 and remat by block, no mesh), and the
benchmark's seeded weights in the port's parameter layout.  It drives that
object through ``checked_steps`` steps on the window's own call and feed,
numbered from ``first_step`` (the warm-up's first step, 0, would have a
learning rate of 0), reading what the comparison needs: each step's loss,
each leaf's norm of the first step's clipped gradient (AdamW's first
moment after one step over 1 - b1) and of the change of the parameters
after the last.  The window then runs further steps back to back on the
same object until ``--seconds`` have passed on the host's clock, and ends
at the step boundary after them with a synchronize.

Once the window has closed and the program's state is freed, the plain
reference (``portbench.reference``) makes the same weights again, takes
the same batches and works out the same steps in float32;
``compare`` gives the numbers the cell's limits hold.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.profiler

from portbench import traffic as traffic_mod
from portbench import weights
from portbench.reference import train as ref_train
from portbench.reference.common import Prec, gather
from portbench.trace import WINDOW, Trace

__all__ = ["Program", "run", "first_steps", "reference_readings", "compare",
           "half_batch", "layer_norms"]

#: leaves whose reference gradient is under this share of the median leaf's
#: move by round-off alone: they are left out of the change
STILL_LEAF = 1e-3


def flat(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def nest(leaves: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for name, v in leaves.items():
        node = out
        *path, last = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def per_layer(leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The leaves with each stacked ``layers.`` leaf split into its layers
    ("layers.attn.wq" -> "layers.0.attn.wq", ...), as views."""
    out = {}
    for name, t in leaves.items():
        if name.startswith("layers."):
            rest = name[len("layers."):]
            for i in range(t.shape[0]):
                out[f"layers.{i}.{rest}"] = t[i]
        else:
            out[name] = t
    return out


def layer_norms(leaves: Dict[str, torch.Tensor], scale: float = 1.0) -> Dict[str, float]:
    """Each per-layer leaf's norm (in float32), read back in one copy."""
    names, norms = [], []
    for name, t in leaves.items():
        t = t.float()
        if name.startswith("layers."):
            rest = name[len("layers."):]
            names += [f"layers.{i}.{rest}" for i in range(t.shape[0])]
            norms.append(torch.linalg.vector_norm(t.flatten(1), dim=1))
        else:
            names.append(name)
            norms.append(torch.linalg.vector_norm(t).reshape(1))
    vals = (torch.cat(norms) * scale).tolist()
    return dict(zip(names, vals))


class Program:
    """The port's training step for one cell, built once."""

    def __init__(self, cell, device):
        from repro_torch.launch.specs import abstract_params
        from repro_torch.models import SINGLE_POD_PLAN
        from repro_torch.models.config import ModelConfig
        from repro_torch.train import TrainSpec, adamw, make_train_step

        self.device = torch.device(device)
        self.model = dict(cell.config["model"])
        self.rules = cell.config.get("init", {})
        self.family = cell.config["reference"]
        self.traffic = cell.workload["traffic"]
        self.hp = cell.workload["train"]
        self.cfg = ModelConfig(**self.model)
        hp = self.hp
        self.opt = adamw(lr=hp["lr"], b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                         weight_decay=hp["weight_decay"])
        spec = TrainSpec(microbatches=1, max_grad_norm=hp["max_grad_norm"], lr=hp["lr"],
                         warmup_steps=hp["warmup_steps"], total_steps=hp["total_steps"],
                         schedule=hp["schedule"])
        self.step = make_train_step(self.cfg, SINGLE_POD_PLAN, None, self.opt, spec)
        meta, _ = abstract_params(self.cfg, SINGLE_POD_PLAN)
        self.layout = {k: (tuple(v.shape), v.dtype) for k, v in flat(meta).items()}

    def weights(self, seed: int) -> Dict[str, torch.Tensor]:
        return weights.make(self.layout, self.rules, seed, self.device)

    def batch(self, seed: int, step: int) -> Dict[str, torch.Tensor]:
        return traffic_mod.batch(self.traffic, self.model, seed, step, self.device)

    def decays(self) -> Dict[str, bool]:
        """Per-layer leaf -> whether the program's AdamW decays it: every
        leaf of two or more dimensions in the program's (stacked) layout."""
        out = {}
        for name, (shape, _) in self.layout.items():
            if name.startswith("layers."):
                rest = name[len("layers."):]
                out.update({f"layers.{i}.{rest}": len(shape) >= 2 for i in range(shape[0])})
            else:
                out[name] = len(shape) >= 2
        return out


Feed = Callable[[int], Dict[str, torch.Tensor]]


def half_batch(feed: Feed) -> Feed:
    """A feed whose second half of tokens (in row order) carries no label:
    the loss is the mean over the first half."""
    def masked(i):
        b = dict(feed(i))
        labels = b["labels"].clone()
        flat_l = labels.view(-1)
        flat_l[flat_l.numel() // 2:] = -1
        b["labels"] = labels
        return b
    return masked


#: elements of the first gradient compared one by one, drawn uniformly
#: over all of its elements
SAMPLE = 1 << 20


def sample_index(prog: Program, seed: int) -> Dict[str, torch.Tensor]:
    """Leaf (as the program stacks it) -> sorted flat indices into it: a
    seeded uniform draw of about SAMPLE elements over the whole tree."""
    gen = torch.Generator(device=prog.device).manual_seed(weights.derive_seed(seed, 9))
    total = sum(math.prod(shape) for shape, _ in prog.layout.values())
    out = {}
    for name, (shape, _) in sorted(prog.layout.items()):
        numel = math.prod(shape)
        k = max(1, round(SAMPLE * numel / total))
        out[name] = torch.sort(torch.randint(0, numel, (k,), generator=gen,
                                             device=prog.device)).values
    return out


def first_steps(prog: Program, seed: int, feed: Optional[Feed] = None):
    """The program from ``seed``'s weights through its checked steps:
    (params, opt_state, readings, losses on the device)."""
    hp = prog.hp
    feed = feed or (lambda i: prog.batch(seed, i))
    params = nest(prog.weights(seed))
    state = prog.opt.init(params)
    losses, grad, sample = [], None, None
    for n in range(hp["checked_steps"]):
        i = hp["first_step"] + n
        params, state, m = prog.step(params, state, feed(i), i)
        losses.append(m["loss"])
        if n == 0:
            mu = flat(state["mu"])
            grad = layer_norms(mu, 1.0 / (1.0 - hp["b1"]))
            sample = gather(mu, sample_index(prog, seed), 1.0 / (1.0 - hp["b1"]))
    p0, p3, change = prog.weights(seed), flat(params), {}
    for k in p0:
        change.update(layer_norms({k: p3[k].float() - p0[k].float()}))
    del p0, p3
    readings = {"losses": [float(x) for x in losses], "grad": grad, "change": change,
                "grad_sample": sample}
    return params, state, readings, losses


def reference_readings(prog: Program, seed: int, prec: Prec = Prec.F32) -> Dict:
    """The plain reference's readings of the checked steps from ``seed``."""
    hp = prog.hp
    leaves0 = per_layer(prog.weights(seed))
    batches = [prog.batch(seed, hp["first_step"] + n) for n in range(hp["checked_steps"])]
    return ref_train.run(prog.family, prog.model, leaves0, prog.decays(), batches, hp,
                         hp["first_step"], prec, sample_index(prog, seed))


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> List[float]:
    med = sorted(ref.values())[len(ref) // 2]
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref if keep(k)]


def compare(got: Dict, ref: Dict) -> Dict[str, float]:
    """Every number the comparison reads; a cell's ``limits`` say which of
    them it holds (PERF.md says why):

    ``grad_diff``   the first clipped gradient's difference from the
                    reference's, over the reference's, in norm, on a seeded
                    uniform sample of SAMPLE of its elements
    ``change_gap``  the worst leaf's gap between the program's and the
                    reference's norm of the change after the checked steps,
                    over the larger of that leaf's and the median leaf's
                    reference norm (leaves whose reference gradient is under
                    STILL_LEAF of the median leaf's left out)
    ``grad_gap``    the same gap for the first clipped gradient, by the
                    worst leaf, and ``grad_gap_median`` by the median leaf
    ``loss_gap``    the widest relative gap of a checked step's loss
    """
    gs, rs = got["grad_sample"], ref["grad_sample"]
    med = sorted(ref["grad"].values())[len(ref["grad"]) // 2]
    moving = {k for k, v in ref["grad"].items() if v >= STILL_LEAF * med}
    grad = _gaps(got["grad"], ref["grad"], lambda k: True)
    out = {"grad_diff": float(torch.linalg.vector_norm(gs - rs) / torch.linalg.vector_norm(rs)),
           "change_gap": max(_gaps(got["change"], ref["change"], lambda k: k in moving)),
           "grad_gap": max(grad), "grad_gap_median": sorted(grad)[len(grad) // 2],
           "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))}
    return {k: (v if math.isfinite(v) else float("inf")) for k, v in out.items()}


def _process_age() -> float:
    """Seconds since this process started, from ``/proc`` (Linux)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def _mem(dev, what: str) -> int:
    if dev.type != "cuda":
        return 0
    return int(getattr(torch.cuda, what)(dev))


def run(cell, seed: int, seconds: float, trace: bool, device) -> Dict:
    """One run of a training cell; returns the driver's result (see
    ``portbench.run``)."""
    dev = torch.device(device)
    t_built = time.perf_counter()
    prog = Program(cell, dev)
    t_built = time.perf_counter() - t_built
    t_first = time.perf_counter()
    params, state, got, losses = first_steps(prog, seed)
    t_first = time.perf_counter() - t_first
    setup_peak = _mem(dev, "max_memory_allocated")
    hp = prog.hp
    i = hp["first_step"] + hp["checked_steps"]
    with contextlib.ExitStack() as stack:
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda"
                                             else [])
            prof = stack.enter_context(profile(activities=acts))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        setup_s = _process_age()
        steps = 0
        with torch.profiler.record_function(WINDOW):
            while True:
                params, state, m = prog.step(params, state, prog.batch(seed, i), i)
                losses.append(m["loss"])
                i += 1
                steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
        peak = _mem(dev, "max_memory_allocated")
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries") if dev.type == "cuda" else 0
    print(f"setup: {setup_s:.2f} s, of it the program built in {t_built:.2f} s and "
          f"its checked steps in {t_first:.2f} s", file=sys.stderr)
    print(f"window: {steps} steps in {window_s:.3f} s, peak {peak / 2 ** 30:.3f} GiB, "
          f"allocator retries since start {retries}", file=sys.stderr)
    reading = None
    if prof is not None:
        tr = Trace(prof)
        reading = {"trace": tr, "kernels": tr.kernels(), "busy_s": tr.busy_s,
                   "trace_window_s": tr.window_s}
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    attempted = len(losses)
    del params, state, m, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(prog, seed)
    numbers = compare(got, ref)
    tokens = steps * traffic_mod.tokens_per_step(prog.traffic)
    return {
        "attempted": attempted, "failed": failed,
        "end_to_end": {"train_tokens_per_s": tokens / window_s,
                       "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
        "steps": steps, "window_s": window_s,
        "memory_peak_bytes": max(peak, setup_peak),
        "reading": reading, "numbers": numbers,
        "model": prog.model, "traffic": prog.traffic,
        "limits": cell.workload["limits"],
    }

