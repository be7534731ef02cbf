from .ops import ssd_chunked, ssd_decode_step
from .ref import ssd_chunked_ref, ssd_ref

__all__ = ["ssd_chunked", "ssd_chunked_ref", "ssd_decode_step", "ssd_ref"]
