from .ops import islip_schedule
from .ref import islip_ref

__all__ = ["islip_ref", "islip_schedule"]
