"""PyTorch/CUDA port of the PIM serving system (twin of ``repro``).

This package holds the port's first slice: greedy decoding of a dense model
from PIM-quantized weights (``serving.ServingEngine``), with every
decode-time linear running through a hand-written CUDA kernel
(``kernels.pim_matvec``).  It imports ``torch`` and never ``jax`` or
``repro``; the CUDA sources build at first use, so importing the package
needs neither a card nor ``nvcc``.
"""
