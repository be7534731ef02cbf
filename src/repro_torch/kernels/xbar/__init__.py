from .ops import xbar_contend

__all__ = ["xbar_contend"]
