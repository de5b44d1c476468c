"""PiCaSO core: bit-serial PIM overlay reproduction (FPL 2023).

Twin of ``repro.core``, on PyTorch tensors.

Layers:
  isa/alu/booth/opmux/network — functional bit-level machine (on the device
                                of the tensors given)
  simulator                   — PE-array machine with cycle accounting
  mapping                     — matvec onto the array, row per output
  costmodel/archmodels        — the paper's analytical latency/throughput/
                                memory-efficiency models (Tables V, VIII)
  devices/scalability         — Table VII device DB + Table VI / Fig 4 model
  paper_tables, array_demo    — the paper's tables and the array walk-through
                                (``python -m repro_torch.core.paper_tables``)

The cycle counts, clocks and throughputs are the paper's analytical model of
the FPGA overlay, not measurements of the device the simulator runs on.
"""
from .isa import OpCode, EncoderConf, booth_decode, encode
from .bitops import to_bits, from_bits, corner_turn, corner_turn_inverse, sign_extend_bits
from .alu import serial_alu, alu_cycles
from .booth import booth_multiply, booth_multiply_bits, booth_cycles, booth_nop_fraction
from .opmux import OpMuxConf, fold_operand, fold_reduce_block, fold_source_index
from .network import network_reduce_bits, node_roles, network_levels
from .simulator import PicasoArray, simulate_dot_product
from . import costmodel, archmodels, devices, scalability

__all__ = [
    "OpCode", "EncoderConf", "booth_decode", "encode",
    "to_bits", "from_bits", "corner_turn", "corner_turn_inverse", "sign_extend_bits",
    "serial_alu", "alu_cycles",
    "booth_multiply", "booth_multiply_bits", "booth_cycles", "booth_nop_fraction",
    "OpMuxConf", "fold_operand", "fold_reduce_block", "fold_source_index",
    "network_reduce_bits", "node_roles", "network_levels",
    "PicasoArray", "simulate_dot_product",
    "costmodel", "archmodels", "devices", "scalability",
]
