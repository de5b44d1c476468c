"""Weight quantization for PIM-mode execution (int8 codes, int4 nibbles,
bit-planes)."""
from .quantize import (
    QuantizedTensor,
    dequantize,
    from_bitplanes,
    pack_int4,
    quantize_symmetric,
    to_bitplanes,
    unpack_int4,
)

__all__ = ["QuantizedTensor", "quantize_symmetric", "dequantize", "pack_int4",
           "unpack_int4", "to_bitplanes", "from_bitplanes"]
