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
from .pim import DENSE_KEYS, quantize_slices, should_quantize

__all__ = ["QuantizedTensor", "DENSE_KEYS", "should_quantize", "quantize_slices", "quantize_symmetric", "dequantize", "pack_int4",
           "unpack_int4", "to_bitplanes", "from_bitplanes"]
