"""Hand-written CUDA kernels for Hopper, each beside its plain version.

Every wrapper here takes the plain PyTorch version for CPU tensors and, for
CUDA tensors, launches its kernel or raises. Each counts its launches in a
module-level ``launches`` integer.
"""
