"""Continuous-batching serving: the shared slot-array core + token engine."""
from .engine import Request, ServeEngine
from .slots import SlotArray

__all__ = ["Request", "ServeEngine", "SlotArray"]
