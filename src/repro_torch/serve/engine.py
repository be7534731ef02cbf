"""Batched serving engine: continuous batching over the decode step.

The port's counterpart of the JAX package's ``serve/engine.py``.
``ServeEngine`` keeps a fixed-width slot array (the serving batch);
requests occupy free slots, finished sequences free them.  ``decode_step``
runs eagerly, one call per tick, on the parameters' device.  The slot
bookkeeping (admission queue, rid ownership, completion-ordered harvest)
lives in :class:`repro_torch.serve.slots.SlotArray`.

Tick accounting, as in the reference: prefill and decode share the tick.
On the tick a request's last prompt token is fed, that step's logits are
sampled, so the first generated token lands on tick ``len(prompt)`` and a
request completes in ``len(prompt) + max_new - 1`` ticks with exactly
``max_new`` output tokens.

Sampling: greedy (argmax of the float32 logits, the first index on ties,
as the reference) or temperature.  Temperature sampling draws Gumbel noise
from a ``torch.Generator`` seeded from ``seed`` (the Gumbel-max form of a
categorical draw): the same distribution as the reference's
``jax.random.categorical``, not its bits.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShardingPlan

from .slots import SlotArray

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [P] int32 tokens (or [P, d] embeddings)
    max_new: int = 16
    temperature: float = 0.0
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: prompt cursor, owned by the engine
    _fed: int = 0


def _device_of(params) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


class ServeEngine:
    def __init__(self, cfg: ModelConfig, plan: ShardingPlan, mesh, params,
                 *, slots: int = 4, s_max: int = 256, seed: int = 0):
        if cfg.frontend != "tokens":
            raise NotImplementedError(
                f"{cfg.name}: the token server feeds token ids; an embeddings "
                "frontend has no tokens to feed back")
        self.cfg, self.plan, self.mesh = cfg, plan, mesh
        self.params = params
        self.slots = slots
        self.s_max = s_max
        self.device = _device_of(params)
        self.gen = torch.Generator().manual_seed(seed)
        self.state = T.init_decode_state(cfg, plan, slots, s_max, device=self.device)
        self._slots: SlotArray[Request] = SlotArray(slots)

    # ------------------------------------------------------------- frontend
    def submit(self, req: Request):
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        self._slots.submit(req.rid, req)

    @property
    def drained(self) -> bool:
        return self._slots.drained

    # ----------------------------------------------------------------- step
    def _sample(self, logits: np.ndarray, temperature: float) -> int:
        if temperature > 0:
            u = torch.rand(logits.shape, generator=self.gen, dtype=torch.float64)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-300)))
            return int(np.argmax(logits / temperature + gumbel.numpy()))
        return int(logits.argmax())

    def step(self) -> int:
        """One engine tick = one decode_step over the slot batch."""
        for _, _, req in self._slots.admit():
            req._fed = 0            # reset the prompt cursor: slots are reused
        tok = np.zeros((self.slots, 1), np.int64)
        for i, _, req in self._slots.active_slots():
            if req._fed < len(req.prompt):
                tok[i, 0] = req.prompt[req._fed]
                req._fed += 1
            elif req.out:
                tok[i, 0] = req.out[-1]
        self.state, logits = T.decode_step(self.params, self.cfg, self.plan, self.mesh,
                                           self.state,
                                           torch.from_numpy(tok).to(self.device))
        logits = logits[:, 0].float().cpu().numpy()
        for i, _, req in list(self._slots.active_slots()):
            if req._fed < len(req.prompt):
                continue                       # still prefilling this slot
            req.out.append(self._sample(logits[i], req.temperature))
            if len(req.out) >= req.max_new:
                req.done = True
                self._slots.finish(i)
        return len(self._slots)

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        """Tick until queue and slots are empty; returns every completed
        request exactly once, in completion order."""
        for _ in range(max_ticks):
            if self._slots.drained:
                break
            self.step()
        return self._slots.harvest()
