"""cudnn_conv_roofline: the nets' convolutions' bound (``counts/bounds.py``,
forward and backward, the traced steps' calls) over the device time of
cuDNN's kernels in the device-only trace, told by name, in %.

A kernel is cuDNN's where its name holds ``fprop``, ``dgrad``, ``wgrad``,
``convolve`` or ``cudnn``: its implicit-GEMM and direct engines, its
CUTLASS kernels and split-K reductions, the layout transforms and padding
it runs around them. cuBLAS's GEMMs (``nvjet``, ``cublasLt``, ``xmma_gemm``)
and ATen's own kernels hold none of these. The name holds wherever the
kernel was launched from: an ATen ``convolution`` op, or a CUDA graph's
replay, which runs no ATen op (``conv_roofline`` reads the ops, so it
loses a graph's convs). ATen's kernels inside the conv ops (the bias's
add, a copy, the bias gradient's sum) are not counted.
"""

PARTS = ("fprop", "dgrad", "wgrad", "convolve", "cudnn")


def seconds(kernel_s) -> float:
    """Device seconds of cuDNN's kernels in ``kernel_s`` (seconds by kernel
    name)."""
    return sum(s for name, s in kernel_s.items()
               if any(part in name for part in PARTS))


def read(run):
    trace = run.trace
    conv_s = None if trace is None else seconds(trace.kernel_s)
    if not conv_s:
        return None
    return 100.0 * run.cell.conv_seconds_per_step * trace.steps / conv_s
