from .ops import combine, dispatch
from .ref import combine_ref, dispatch_ref

__all__ = ["combine", "combine_ref", "dispatch", "dispatch_ref"]
