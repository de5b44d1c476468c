"""Weight quantization for PIM-mode execution (int8 codes, int4 nibbles)."""
from .quantize import (
    QuantizedTensor,
    dequantize,
    pack_int4,
    quantize_symmetric,
    unpack_int4,
)

__all__ = ["QuantizedTensor", "quantize_symmetric", "dequantize", "pack_int4",
           "unpack_int4"]
