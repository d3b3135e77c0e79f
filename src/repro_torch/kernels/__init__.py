"""The port's kernels: hand-written CUDA C++ for Hopper (``csrc/``), each
with its plain PyTorch version beside it, plus the oracles (``ref``) and
the reference-layout wrappers (``ops``). Importing builds nothing."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
