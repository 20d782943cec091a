"""Hand-written CUDA kernels for Hopper, each beside its plain version.

Every wrapper here takes the plain PyTorch version for CPU tensors and, for
CUDA tensors, launches its kernel or raises. After each launch it counts
the run on the card (``run_count``), so a launch a CUDA graph captured
counts each replay; the plain version counts nothing.
"""
