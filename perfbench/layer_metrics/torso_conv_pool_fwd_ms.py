"""torso_conv_pool_fwd_ms: device ms a train step of the torsos' forward
convolutions and pools in the device-only trace, told by name, wherever
they were launched from (an ATen op, or a CUDA graph's replay, which opens
no ``torso`` span: ``torso_fwd_ms`` reads the span, so it loses a graph's
torsos).

The names: cuDNN's forward engines (``fprop``, ``convolve``), the layout
transforms cuDNN runs around a forward conv (``ToNchwKernel``,
``ToNhwcKernel``) and ATen's pool forward (``max_pool_forward``). The
torso's elementwise kernels (the bias's add, ReLU, casts, padding's fill)
share their names with kernels outside it and are not counted; nor is a
backward's.
"""

PARTS = ("fprop", "convolve", "ToNchwKernel", "ToNhwcKernel",
         "max_pool_forward")


def read(run):
    trace = run.trace
    if trace is None:
        return None
    found = [s for name, s in trace.kernel_s.items()
             if any(part in name for part in PARTS)]
    if not found:
        return None
    return 1e3 * sum(found) / trace.steps
