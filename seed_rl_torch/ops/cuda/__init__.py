"""Hand-written CUDA kernels for Hopper, each beside its plain version.

Every wrapper here takes the plain PyTorch version for CPU tensors and, for
CUDA tensors, launches its kernel or raises. Each counts the launches the
host made in a module-level ``launches`` integer; the n-step kernel, which
R2D2's update graph replays, also counts its runs on the device
(``nstep_kernel.runs()``).
"""
