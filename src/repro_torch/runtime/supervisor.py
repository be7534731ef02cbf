"""Fault-tolerant run supervisor: checkpoint/restart, straggler watch.

At 1000+ nodes the dominant failure mode is a lost worker; the contract here
is the standard one: training state is *only* (params, opt_state, data_step),
every piece of it restores from the last atomic checkpoint, and the outer
loop survives any number of step-level failures up to ``max_restarts``.

``FaultInjector`` provides deterministic failure/straggler injection so the
restart and mitigation paths are *tested*, not just written (see
tests/test_runtime.py).  The straggler policy is EWMA step-time tracking with
a deadline multiple: on breach the supervisor records the event and invokes
the mitigation hook (on real fleets: re-dispatch the slice / swap in a hot
spare; on CPU: the hook is observed by tests).

The port's copy of the JAX package's ``runtime/supervisor.py``, over the
port's ``checkpoint/store.py`` (the reference's on-disk format, so a run
either package checkpoints resumes in the other).  The state is the
``(params, opt_state)`` tree of tensors.  A step's time is the host's
time in ``step_fn``, as in the reference (on a card that is the work
queued, unless ``step_fn`` waits for it).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.store import AsyncCheckpointer, latest_step, restore

__all__ = ["NodeFailure", "FaultInjector", "StragglerWatch", "Supervisor", "RunResult"]


class NodeFailure(RuntimeError):
    """Raised by the fault injector (stands in for a lost device)."""


@dataclasses.dataclass
class FaultInjector:
    """Deterministic failure schedule: {step: kind} with kind in
    {"crash", "straggle:<seconds>"}."""

    schedule: Dict[int, str] = dataclasses.field(default_factory=dict)
    fired: List[int] = dataclasses.field(default_factory=list)

    def maybe_fire(self, step: int):
        kind = self.schedule.get(step)
        if kind is None or step in self.fired:
            return
        self.fired.append(step)
        if kind == "crash":
            raise NodeFailure(f"injected node failure at step {step}")
        if kind.startswith("straggle:"):
            time.sleep(float(kind.split(":")[1]))


@dataclasses.dataclass
class StragglerWatch:
    deadline_multiple: float = 3.0
    ewma_alpha: float = 0.2
    _ewma: Optional[float] = None
    events: List[Dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float, on_straggler: Optional[Callable] = None):
        if self._ewma is None:
            self._ewma = dt
            return False
        breach = dt > self.deadline_multiple * self._ewma
        if breach:
            self.events.append({"step": step, "dt": dt, "ewma": self._ewma})
            if on_straggler:
                on_straggler(step, dt, self._ewma)
        # slow samples leak into the EWMA slowly; healthy ones dominate
        self._ewma = (1 - self.ewma_alpha) * self._ewma + self.ewma_alpha * min(
            dt, 2 * self._ewma)
        return breach


@dataclasses.dataclass
class RunResult:
    final_step: int
    restarts: int
    straggler_events: List[Dict]
    metrics_history: List[Dict]


class Supervisor:
    def __init__(
        self,
        ckpt_dir: str,
        *,
        ckpt_every: int = 50,
        max_restarts: int = 5,
        injector: Optional[FaultInjector] = None,
        straggler: Optional[StragglerWatch] = None,
    ):
        self.ckpt = AsyncCheckpointer(ckpt_dir)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.injector = injector
        self.straggler = straggler or StragglerWatch()

    def run(
        self,
        state: Any,                       # pytree: (params, opt_state, ...)
        step_fn: Callable[[Any, int], Any],   # (state, step) -> (state, metrics)
        *,
        start_step: int = 0,
        total_steps: int = 100,
        on_straggler: Optional[Callable] = None,
    ) -> RunResult:
        restarts = 0
        history: List[Dict] = []
        step = start_step
        # resume if a checkpoint exists
        last = latest_step(self.ckpt_dir)
        if last is not None and last > step:
            state, _ = restore(self.ckpt_dir, last, template=state)
            step = last
        while step < total_steps:
            try:
                t0 = time.time()
                if self.injector:
                    self.injector.maybe_fire(step)
                state, metrics = step_fn(state, step)
                dt = time.time() - t0
                self.straggler.observe(step, dt, on_straggler)
                history.append({"step": step, **{k: float(v) for k, v in metrics.items()}})
                step += 1
                if step % self.ckpt_every == 0 or step == total_steps:
                    self.ckpt.save_async(step, state, extra={"step": step})
            except NodeFailure:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                last = latest_step(self.ckpt_dir)
                if last is not None:
                    state, _ = restore(self.ckpt_dir, last, template=state)
                    step = last
                # else: restart from the initial state at start_step
        self.ckpt.wait()
        return RunResult(final_step=step, restarts=restarts,
                         straggler_events=self.straggler.events,
                         metrics_history=history)
