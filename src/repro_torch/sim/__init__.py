"""Simulation stack (paper §IV-A) of the port: the analytic resource model,
the serial surrogate and netsim oracles, the batched stage-2/stage-4 fan-out
engines and the switch DSE problem.  The engine ladder (``sim/engines.py``)
and the cycle-level switch are not ported yet."""
from .backannotate import HardwareParams, analytic_eta, annotate
from .batched_netsim import run_netsim_batched
from .batched_surrogate import BatchedSurrogateResult, run_surrogate_batched
from .netsim import NetSimConfig, run_netsim
from .resources import ALVEO_U45N, ResourceReport, estimate_quick, synthesize
from .surrogate import run_surrogate
from .switch_problem import (CoDesignCandidate, SwitchDSEProblem,
                             align_depth_to_bram, optimize_switch)

__all__ = [
    "ALVEO_U45N", "BatchedSurrogateResult", "CoDesignCandidate",
    "HardwareParams", "NetSimConfig", "ResourceReport", "SwitchDSEProblem",
    "align_depth_to_bram", "analytic_eta", "annotate", "estimate_quick",
    "optimize_switch", "run_netsim", "run_netsim_batched", "run_surrogate",
    "run_surrogate_batched", "synthesize",
]
