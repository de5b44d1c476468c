"""PyTorch/CUDA port of the PIM serving system (twin of ``repro``).

This package holds greedy decoding of a dense model from PIM-quantized
weights (``serving.ServingEngine``), with every decode-time linear running
through a hand-written CUDA kernel (``kernels.pim_matvec``), and the public
kernel entry point ``kernels.ops``: the packed quantized dense layer
(``pim_matmul``), its bit-plane form (``bitplane_matmul``) and the OpMux
fold (``fold_reduce``), each a hand-written CUDA kernel.  A prompt longer
than 8,192 tokens is prefilled through the online-softmax attention
``kernels.flash_attention`` (hand-written CUDA too, one launch per layer).
It imports ``torch`` and never ``jax`` or ``repro``; the CUDA sources build
at first use, so importing the package needs neither a card nor ``nvcc``.
"""
