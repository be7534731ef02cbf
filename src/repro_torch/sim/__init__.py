"""Multi-fidelity simulation stack (paper §IV-A) of the port: the engine
ladder from the analytic resource model up to the cycle-accurate datapath
(``repro_torch.switch``), plus the batched stage-2/stage-4 fan-out engines
and the switch DSE problem."""
from .backannotate import HardwareParams, analytic_eta, annotate
from .batched_netsim import run_netsim_batched
from .batched_surrogate import BatchedSurrogateResult, run_surrogate_batched
from .engines import ENGINES, EngineSpec, get_engine, ladder, register_engine
from .netsim import NetSimConfig, run_netsim
from .resources import ALVEO_U45N, ResourceReport, estimate_quick, synthesize
from .surrogate import run_surrogate
from .switch_problem import (CoDesignCandidate, SwitchDSEProblem,
                             align_depth_to_bram, optimize_switch)

__all__ = [
    "ALVEO_U45N", "BatchedSurrogateResult", "CoDesignCandidate", "ENGINES",
    "EngineSpec", "HardwareParams", "NetSimConfig", "ResourceReport",
    "SwitchDSEProblem",
    "align_depth_to_bram", "analytic_eta", "annotate", "estimate_quick",
    "get_engine", "ladder", "optimize_switch", "register_engine", "run_netsim",
    "run_netsim_batched", "run_surrogate", "run_surrogate_batched",
    "synthesize",
]
