from .ops import parse_headers
from .ref import bake_slices, parse_ref

__all__ = ["bake_slices", "parse_headers", "parse_ref"]
