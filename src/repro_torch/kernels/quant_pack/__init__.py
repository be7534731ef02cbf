from .ops import (GROUP, compress, compression_ratio, decompress, dequantize,
                  quantize)
from .ref import dequantize_ref, quantize_ref

__all__ = ["GROUP", "compress", "compression_ratio", "decompress",
           "dequantize", "dequantize_ref", "quantize", "quantize_ref"]
