from .ops import Slices, parse_headers, slices
from .ref import bake_slices, parse_ref

__all__ = ["Slices", "bake_slices", "parse_headers", "parse_ref", "slices"]
