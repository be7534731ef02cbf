from .ops import switch_loop
from .ref import SwitchLoopOut, egress_ref, ingress_ref, switch_loop_ref

__all__ = ["SwitchLoopOut", "egress_ref", "ingress_ref", "switch_loop", "switch_loop_ref"]
