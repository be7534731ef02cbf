"""Mesh-agnostic checkpointing with async snapshots (the port's copy of the
JAX package's ``checkpoint``, on NumPy and torch)."""
from .store import AsyncCheckpointer, latest_step, restore, save
__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
