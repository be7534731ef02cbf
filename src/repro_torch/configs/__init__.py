"""Assigned architecture configs (10) + smoke variants + input shapes."""
from .registry import ARCHS, all_arch_names, get_config, get_smoke, smoke_variant
from .shapes import SHAPES, ShapeSpec, shapes_for

__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "all_arch_names", "get_config",
           "get_smoke", "shapes_for", "smoke_variant"]
