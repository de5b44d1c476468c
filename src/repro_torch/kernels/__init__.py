"""Hand-written CUDA kernels of the port, each beside its plain version.

A kernel builds at its first launch on a CUDA tensor (``build.py``); on CPU
tensors the wrappers run the plain versions, which is what the CPU tests
exercise.
"""
from .epilogue import ACTIVATIONS, apply_epilogue
from .pim_matvec import MAX_M, pim_matvec, pim_matvec_plain

__all__ = ["ACTIVATIONS", "apply_epilogue", "MAX_M", "pim_matvec",
           "pim_matvec_plain"]
