"""Max pooling with TF/XLA SAME padding.

Port of ``seed_rl_tpu/ops/pooling.py::max_pool_same``, the pool inside the
IMPALA residual stacks. SAME padding may be asymmetric (more at the high
end), which ``F.max_pool2d``'s symmetric ``padding`` cannot express, so the
input is padded with -inf per ``_same_pads`` first and pooled unpadded.

The backward is PyTorch's own: ``max_pool2d`` records, per window, the
first maximal element in row-major window order (a later element wins only
if strictly greater, on the CPU and in its CUDA kernels alike), and routes
the window's gradient there. That is the tie rule of the JAX package's
custom backward and of XLA's SelectAndScatter, so the port needs no
``custom_pool_bwd`` switch: the JAX package's two settings give the same
values, and both are held against this one in the tests.

The pool runs in its input's dtype (bf16 under a bf16 torso): -inf pads
and ``max_pool2d``'s comparisons are exact in any floating dtype, so the
values and the tie rule are the same as in f32.

Unlike the JAX package, which checks ``window <= 2 * stride`` only in its
backward, every window/stride pair is taken here: the backward does not
depend on it.
"""

from typing import Tuple

import torch
import torch.nn.functional as F


def _same_pads(size: int, window: int, stride: int):
    """TF/XLA SAME padding (lo, hi) for one spatial dim."""
    out = -(-size // stride)  # ceil
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def max_pool_same(
    x: torch.Tensor,
    window: Tuple[int, int] = (3, 3),
    strides: Tuple[int, int] = (2, 2),
) -> torch.Tensor:
    """Max pool over the last two dims of NCHW ``x``, SAME padding.

    Values equal ``flax.linen.max_pool(x_nhwc, window, strides, "SAME")``;
    the gradient goes to the first maximum of each window in row-major
    order. Either memory format (NCHW or channels_last) is taken.
    """
    lo_h, hi_h = _same_pads(x.shape[-2], window[0], strides[0])
    lo_w, hi_w = _same_pads(x.shape[-1], window[1], strides[1])
    if lo_h or hi_h or lo_w or hi_w:
        x = F.pad(x, (lo_w, hi_w, lo_h, hi_h), value=-torch.inf)
    return F.max_pool2d(x, window, strides)
