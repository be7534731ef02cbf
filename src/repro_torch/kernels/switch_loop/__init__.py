from .ops import switch_loop
from .ref import SwitchLoopOut, switch_loop_ref

__all__ = ["SwitchLoopOut", "switch_loop", "switch_loop_ref"]
