"""SPAC DSE over the TPU comm/dispatch layer (DESIGN.md §2.2).

Algorithm 1, verbatim machinery (``repro.core.dse``), re-targeted: the
"trace" is the model's own routing trace (token → expert = packet → port),
the "templates" are ``CommSpec``s (capacity factor / payload dtype / a2a
schedule / microbatches), stage-2's infinite-buffer surrogate is an analytic
roofline model fed by expert-load histograms, stage-3 sizes the capacity
factor exactly like the paper sizes VOQ depths (load-quantile @ token-drop
rate ε, aligned to MXU tiles), and stage-4 verifies by running the real
fabric.

The port's copy of the JAX package's ``comm/dse_comm.py``.  The NumPy parts
(the analytic formulas, ``np.quantile``, ``np.bincount``) are verbatim;
the router and the fabric run on the tensors' device (``models/moe.py``,
the int8 payload through the hand-written quant_pack kernels on the card).
``mesh`` is None (one device) or a ``launch.mesh.Mesh`` the verified fabric
runs over; ``model_tp`` (default: the mesh's tensor extent) sets the tensor
extent the analytic model prices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dse import (DSEProblem, ResourceBudget, SLA,
                                  SurrogateResult, VerifyResult, run_dse)
from repro_torch.core.search import DesignSpace, Dim
from repro_torch.launch.roofline import TPU_V5E
from repro_torch.models.config import ModelConfig, ShardingPlan
from repro_torch.models.moe import MoEOptions, apply_moe, router_matmul, top_k

__all__ = ["CommSpec", "CommDSEProblem", "route_trace", "autotune_moe"]


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """One comm-layer candidate (the fabric's SwitchArch analogue)."""

    capacity_factor: float = 1.25
    payload: str = "bf16"          # bf16 | int8
    a2a_chunks: int = 1
    microbatches: int = 1

    def moe_options(self, router: str = "learned_topk") -> MoEOptions:
        return MoEOptions(capacity_factor=self.capacity_factor,
                          payload=self.payload, a2a_chunks=self.a2a_chunks,
                          router=router)

    def short(self) -> str:
        return (f"cf={self.capacity_factor:.2f}/{self.payload}/"
                f"a2a×{self.a2a_chunks}/µb={self.microbatches}")


def route_trace(params, cfg: ModelConfig, x: torch.Tensor, tp_size: int,
                n_rounds: int = 8) -> np.ndarray:
    """Per-dispatch-round expert-load matrix [rounds, E] — the traffic trace.

    Runs only the router (cheap) over shards of the token stream, mirroring
    how each device slice routes independently in the fabric.
    """
    e, k = cfg.moe_experts, cfg.moe_topk
    flat = x.reshape(-1, x.shape[-1])
    t_m = max(flat.shape[0] // n_rounds, 1)
    loads = []
    for r in range(n_rounds):
        xs = flat[r * t_m:(r + 1) * t_m]
        if xs.shape[0] == 0:
            break
        logits = router_matmul(xs.to(torch.float32), params["router"])
        _, experts = top_k(logits, k)
        counts = np.bincount(experts.cpu().numpy().reshape(-1), minlength=e)
        loads.append(counts)
    return np.asarray(loads)                      # [rounds, E]


class CommDSEProblem(DSEProblem):
    def __init__(
        self,
        params,
        cfg: ModelConfig,
        plan: ShardingPlan,
        mesh,
        sample_x: torch.Tensor,                   # [B, S, d] routing sample
        *,
        tokens_per_device: Optional[int] = None,
        model_tp: Optional[int] = None,     # tensor extent for the analytic
        hw: Dict = TPU_V5E,                 # model (default: the actual mesh)
    ):
        self.params, self.cfg, self.plan, self.mesh = params, cfg, plan, mesh
        self.sample_x = sample_x
        self.tp_size = model_tp or (mesh.shape[plan.tp_axis] if mesh is not None
                                    else 1)
        self.hw = hw
        self.loads = route_trace(params, cfg, sample_x, self.tp_size)
        self.tokens_per_round = int(self.loads.sum(1).mean()) // cfg.moe_topk
        self.tokens_per_device = tokens_per_device or self.tokens_per_round

    # ------------------------------------------------------------- helpers
    def _buffer_bytes(self, c: CommSpec) -> float:
        """Dispatch-buffer footprint per device (the BRAM analogue)."""
        t_m = self.tokens_per_device / c.microbatches
        cap = t_m * self.cfg.moe_topk / self.cfg.moe_experts * c.capacity_factor
        slot = self.cfg.d_model * (1 if c.payload == "int8" else 2)
        return 2.0 * self.cfg.moe_experts * max(cap, 1) * slot   # send+recv

    def _a2a_bytes_batch(self, cs: List[CommSpec]) -> np.ndarray:
        """Wire bytes per step per device (both directions, all µbatches) for
        a whole candidate batch — the single home of the formula; the scalar
        helper delegates here so the two can never drift."""
        cf = np.array([c.capacity_factor for c in cs], np.float64)
        slot = self.cfg.d_model * np.array(
            [1 if c.payload == "int8" else 2 for c in cs], np.float64)
        slots = self.tokens_per_device * self.cfg.moe_topk * cf
        frac_remote = (self.tp_size - 1) / self.tp_size
        return 2.0 * slots * slot * frac_remote

    def _a2a_bytes(self, c: CommSpec) -> float:
        return float(self._a2a_bytes_batch([c])[0])

    def _step_time_batch(self, cs: List[CommSpec]) -> np.ndarray:
        """Analytic fabric time: max(compute, wire) per chunk + issue cost."""
        cf = np.array([c.capacity_factor for c in cs], np.float64)
        chunks = np.maximum(np.array([c.a2a_chunks for c in cs]), 1)
        slots = self.tokens_per_device * self.cfg.moe_topk * cf
        flops = 3 * 2 * slots * self.cfg.d_model * self.cfg.d_ff
        t_compute = flops / self.hw["peak_flops_bf16"]
        t_wire = self._a2a_bytes_batch(cs) / self.hw["ici_link_gbps"]
        t_issue = 5e-6 * chunks                   # per-collective issue cost
        per = np.maximum(t_compute, t_wire) / chunks
        return np.where(chunks > 1,               # pipelined: overlap comm/compute
                        per * (chunks + 1) + t_issue,
                        t_compute + t_wire + t_issue)

    def _step_time(self, c: CommSpec) -> float:
        return float(self._step_time_batch([c])[0])

    # ------------------------------------------------------------- Alg. 1
    def candidates(self) -> List[CommSpec]:
        out = []
        for payload in ("bf16", "int8"):
            for chunks in (1, 2, 4):
                for mb in (1, 2):
                    out.append(CommSpec(capacity_factor=2.0, payload=payload,
                                        a2a_chunks=chunks, microbatches=mb))
        return out

    # ------------------------------------------------------ search support
    def space(self) -> DesignSpace:
        """Parameterized fabric space for the generational search engine —
        per-dimension ranges (wider than the ``candidates()`` grid: 8-way
        a2a chunking and 4 microbatches join the sweep).  The capacity
        factor stays out of the genome: stage 3 *sizes* it from the routing
        trace exactly like VOQ depths."""
        return DesignSpace((
            Dim("payload", ("bf16", "int8")),
            Dim("a2a_chunks", (1, 2, 4, 8)),
            Dim("microbatches", (1, 2, 4)),
        ))

    def decode(self, assignment) -> CommSpec:
        return CommSpec(capacity_factor=2.0,
                        payload=assignment["payload"],
                        a2a_chunks=assignment["a2a_chunks"],
                        microbatches=assignment["microbatches"])

    def static_timing(self, c: CommSpec) -> Tuple[float, float]:
        """Stage-1 prune: dispatch buffers must clear the HBM headroom within
        the per-step arrival budget (line-rate feasibility analogue)."""
        t_proc = self._buffer_bytes(c) / self.hw["hbm_gbps"]
        t_arrival = self.tokens_per_device * self.cfg.d_model * 2 / self.hw["hbm_gbps"]
        return t_proc, 8.0 * t_arrival            # δ folded into the budget

    def surrogate(self, c: CommSpec) -> SurrogateResult:
        """Stage 2: infinite buffers — per-expert occupancy from the routing
        trace; latency distribution from the analytic fabric model.  One body
        with the batch path so the two can never drift."""
        return self.surrogate_batch([c])[0]

    def surrogate_batch(self, cands: List[CommSpec]) -> List[SurrogateResult]:
        """Stage-2 fan-out: the fabric model is closed-form, so the whole
        candidate batch reduces to one pass over the vectorised formulas."""
        if not cands:
            return []
        t = self._step_time_batch(cands)
        a2a = self._a2a_bytes_batch(cands)
        occupancy = self.loads.reshape(-1) / max(self.loads.mean(), 1e-9)
        return [
            SurrogateResult(
                q_occupancy=occupancy.copy(),   # no aliasing across candidates
                latency_ns=np.full(16, tb * 1e9),
                throughput_gbps=float(ab * 8 / max(tb, 1e-12) / 1e9),
                meta={"step_s": float(tb), "batched": True})
            for tb, ab in zip(t, a2a)
        ]

    def size_buffers(self, c: CommSpec, occupancy: np.ndarray, eps: float) -> CommSpec:
        """Stage 3: capacity factor = (1-ε) quantile of normalised expert load,
        aligned up to MXU-tile token multiples."""
        cf = float(np.quantile(occupancy, 1.0 - eps))
        t_m = max(self.tokens_per_device / c.microbatches, 1)
        slot_quantum = 8 * self.cfg.moe_experts / (t_m * self.cfg.moe_topk)
        cf = math.ceil(cf / max(slot_quantum, 1e-9)) * slot_quantum
        return dataclasses.replace(c, capacity_factor=max(round(cf, 3), 0.05))

    def resources(self, c: CommSpec) -> Dict[str, float]:
        b = self._buffer_bytes(c)
        return {"bytes_per_device": b, "bram": b}

    def verify(self, c: CommSpec) -> VerifyResult:
        """Stage 4: run the real fabric; measure the actual token-drop rate.
        One body with the batch path so the two can never drift."""
        return self.verify_batch([c])[0]

    def verify_batch(self, cands: List[CommSpec]) -> List[VerifyResult]:
        """Stage-4 fan-out: the analytic fabric metrics (step time, wire
        bytes) vectorise over the whole batch in one pass; only the genuinely
        dynamic part — dispatching through the real fabric to measure the
        actual token-drop rate — stays per candidate."""
        if not cands:
            return []
        t = self._step_time_batch(cands)
        a2a = self._a2a_bytes_batch(cands)
        out: List[VerifyResult] = []
        for c, tb, ab in zip(cands, t, a2a):
            _, aux = apply_moe(self.params, self.cfg, self.plan, self.mesh,
                               self.sample_x, c.moe_options(self.cfg.router))
            out.append(VerifyResult(
                p99_latency_ns=float(tb) * 1e9, mean_latency_ns=float(tb) * 1e9,
                drop_rate=float(aux["drop_frac"]),
                throughput_gbps=float(ab) * 8 / max(float(tb), 1e-12) / 1e9,
                meta={"expert_load": aux["expert_load"].cpu().numpy()}))
        return out

    def objectives(self, c: CommSpec, v: VerifyResult) -> Tuple[float, float]:
        return (v.p99_latency_ns, self._buffer_bytes(c))


def autotune_moe(params, cfg, plan, mesh, sample_x, *,
                 sla: Optional[SLA] = None, hbm_budget_bytes: float = 4e9,
                 model_tp: Optional[int] = None, verbose: bool = False):
    """One-call fabric auto-tune: routing trace in, Pareto CommSpec out.
    ``params`` and ``sample_x`` are tensors of one device; ``mesh`` is None
    (the fabric runs there) or a ``launch.mesh.Mesh``."""
    problem = CommDSEProblem(params, cfg, plan, mesh, sample_x, model_tp=model_tp)
    sla = sla or SLA(p99_latency_ns=math.inf, drop_rate=2e-2)
    budget = ResourceBudget({"bytes_per_device": hbm_budget_bytes})
    result = run_dse(problem, sla, budget, top_k=8, verbose=verbose)
    return result, problem
