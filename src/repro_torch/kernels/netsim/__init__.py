from .ops import (ChainIndex, build_chain_index, kernel_available,
                  lean_replay, netsim_fixed_point, resolve_use_kernel,
                  segmented_admission, segmented_occupancy)
from .ref import netsim_replay_abs_ref, netsim_replay_slack_ref

__all__ = [
    "ChainIndex", "build_chain_index", "kernel_available", "lean_replay",
    "netsim_fixed_point", "resolve_use_kernel", "segmented_admission",
    "segmented_occupancy", "netsim_replay_abs_ref", "netsim_replay_slack_ref",
]
