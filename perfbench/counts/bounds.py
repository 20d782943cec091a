"""Frozen byte and operation counts: the least time the card could take
for the nets' convolutions and for the two hand kernels.

A bound is the larger of the operations at the peak rate and the bytes at
the memory rate (``flops.py``'s H100 peaks); each input byte is counted
read once and each output byte written once. The kernel counts are frozen
copies of ``chip_smoke.py``'s ``_vtrace_bound_ms`` (B1) and
``_nstep_bound_ms`` (B2); the conv count is ``tools/exp_packed_conv.py``'s
``bound`` taken to the backward.
"""

from typing import List, NamedTuple, Sequence, Tuple

from perfbench.counts.flops import (
    HBM_BYTES_PER_S,
    PEAK_BF16_FLOPS,
    PEAK_FP32_FLOPS,
)

# B1's and B2's operations an element, as chip_smoke.py counts them.
VTRACE_OPS_PER_ELEMENT = 18
NSTEP_OPS_PER_ELEMENT = 11 + 3 * 5 + 7 + 4


class Conv(NamedTuple):
    h: int  # input height and width
    w: int
    cin: int
    cout: int
    k: int
    oh: int  # output height and width
    ow: int
    first: bool  # its input is the frames: the backward computes no dx


def impala_convs(h: int, w: int, cin: int,
                 stacks: Sequence[Tuple[int, int]] = ((16, 2), (32, 2),
                                                      (32, 2))) -> List[Conv]:
    """ImpalaDeep's torso: per stack a 3x3 SAME conv at its input's size,
    a 3x3/2 SAME pool, then 2 convs a residual block."""
    convs = []
    for ch, blocks in stacks:
        convs.append(Conv(h, w, cin, ch, 3, h, w, not convs))
        h, w = (h + 1) // 2, (w + 1) // 2
        convs += [Conv(h, w, ch, ch, 3, h, w, False)] * (2 * blocks)
        cin = ch
    return convs


def nature_convs(h: int = 84, w: int = 84, cin: int = 4) -> List[Conv]:
    """The Nature-DQN stack, VALID."""
    convs = []
    for cout, k, s in ((32, 8, 4), (64, 4, 2), (64, 3, 1)):
        oh, ow = (h - k) // s + 1, (w - k) // s + 1
        convs.append(Conv(h, w, cin, cout, k, oh, ow, not convs))
        h, w, cin = oh, ow, cout
    return convs


def _seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)


def conv_seconds(conv: Conv, n: int, train: bool, elem: int = 2) -> float:
    """The bound of one call of ``conv`` on ``n`` frames in an ``elem``-byte
    type: the forward, and with ``train`` its backward (dw, and dx unless
    the input is the frames), each pass on its own."""
    c = conv
    x = n * c.h * c.w * c.cin * elem
    y = n * c.oh * c.ow * c.cout * elem
    wgt = (c.cout * c.cin * c.k * c.k + c.cout) * elem
    flops = 2.0 * n * c.oh * c.ow * c.cout * c.cin * c.k * c.k
    total = _seconds(flops, x + wgt + y, PEAK_BF16_FLOPS)
    if train:
        total += _seconds(flops, x + y + wgt, PEAK_BF16_FLOPS)  # dw
        if not c.first:
            total += _seconds(flops, y + wgt + x, PEAK_BF16_FLOPS)  # dx
    return total


def convs_seconds(convs: Sequence[Conv], n: int, train: bool) -> float:
    return sum(conv_seconds(c, n, train) for c in convs)


def vtrace_seconds(t: int, b: int) -> float:
    """B1 at [T, B]: five [T, B] f32 inputs and a [B] one read, two [T, B]
    outputs written."""
    nbytes = ((5 * t + 1) * b + 2 * t * b) * 4
    return _seconds(VTRACE_OPS_PER_ELEMENT * t * b, nbytes, PEAK_FP32_FLOPS)


def nstep_seconds(t: int, b: int, done_bytes: int = 1) -> float:
    """B2 at [T, B]: three [T, B] f32 inputs and ``done`` read, the
    [T-1, B] targets and the [B] priorities written."""
    nbytes = (3 * 4 + done_bytes) * t * b + ((t - 1) * b + b) * 4
    return _seconds(NSTEP_OPS_PER_ELEMENT * t * b, nbytes, PEAK_FP32_FLOPS)
