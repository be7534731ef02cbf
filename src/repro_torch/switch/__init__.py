"""Cycle-level PyTorch model of the SPAC switch datapath (paper SS III-B).

Module map: parser.py (SS III-B.1), forward_table.py (SS III-B.2),
voq.py (SS III-B.3), scheduler.py (SS III-B.4), switch.py (composition;
egress/deparser is the departure path inside ``simulate``).  Port of the
JAX package's ``switch``; on a card the header parser and the whole cycle
loop run as hand-written CUDA kernels
(``repro_torch.kernels.{parser,switch_loop}``); the eager loop, the
fused loop's plain version, runs on the CPU.
"""
from .forward_table import BROADCAST, init_table, learn, lookup
from .parser import make_field_extractor, n_header_words, pack_header_words
from .scheduler import SchedState, init_sched, schedule
from .switch import SwitchSimResult, prepare_cycle_inputs, sim_result, simulate
from .voq import VOQState, init_voq, occupancy, enqueue, dequeue

__all__ = [
    "BROADCAST", "SchedState", "SwitchSimResult", "VOQState", "dequeue",
    "enqueue", "init_sched", "init_table", "init_voq", "learn", "lookup",
    "make_field_extractor", "n_header_words", "occupancy",
    "pack_header_words", "prepare_cycle_inputs", "schedule", "sim_result",
    "simulate",
]
