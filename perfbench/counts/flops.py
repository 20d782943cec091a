"""Frozen FLOP counts of the benchmark's nets, and the H100's peaks.

A copy of the port's ``utils/flops.py`` as it stood when the benchmark was
defined (the program may change; the yardstick may not): forward FLOPs per
frame from the layer shapes, a multiply-accumulate counted as 2 FLOPs,
convs at their output resolution, dense layers 2 * in * out, an LSTM 4
gates of 2 * (in + hidden) * hidden; biases, activations and pools left
out. A backward pass counts twice its forward (dx and dw), so a trained
frame costs 3 forwards.

Peaks: NVIDIA's H100 SXM5 data sheet, dense, at the 700 W limit.
"""

from typing import Sequence, Tuple

PEAK_BF16_FLOPS = 989e12  # BF16 tensor cores
PEAK_FP32_FLOPS = 67e12  # FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3


def conv2d(out_h: int, out_w: int, cin: int, cout: int, k: int) -> int:
    return out_h * out_w * cout * cin * k * k * 2


def dense(cin: int, cout: int) -> int:
    return cin * cout * 2


def lstm(in_size: int, hidden: int) -> int:
    return 4 * (in_size + hidden) * hidden * 2


def nature_torso(h: int = 84, w: int = 84, cin: int = 4) -> int:
    """The Nature-DQN stack (32,8,4)(64,4,2)(64,3,1), VALID, + Dense 512."""
    total = 0
    for cout, k, s in ((32, 8, 4), (64, 4, 2), (64, 3, 1)):
        oh, ow = (h - k) // s + 1, (w - k) // s + 1
        total += conv2d(oh, ow, cin, cout, k)
        h, w, cin = oh, ow, cout
    return total + dense(h * w * cin, 512)


def dueling_lstm_dqn_net(num_actions: int, lstm_size: int = 512,
                         stack_size: int = 4) -> int:
    """DuelingLSTMDQNNet: torso, LSTM, value and advantage branches."""
    return (nature_torso(cin=stack_size)
            + lstm(512 + 1 + num_actions, lstm_size)
            + dense(lstm_size, 512) + dense(512, 1)
            + dense(lstm_size, 512) + dense(512, num_actions))


def impala_resnet_torso(
    h: int, w: int, cin: int,
    stacks: Sequence[Tuple[int, int]] = ((16, 2), (32, 2), (32, 2)),
    dense_out: int = 256,
) -> int:
    """SAME 3x3 convs, the downscale conv at the stack's input resolution,
    a 3x3/2 pool, then 2 convs a residual block."""
    total = 0
    for ch, blocks in stacks:
        total += conv2d(h, w, cin, ch, 3)
        h, w = (h + 1) // 2, (w + 1) // 2
        total += blocks * 2 * conv2d(h, w, ch, ch, 3)
        cin = ch
    return total + dense(h * w * cin, dense_out)


def impala_deep(num_actions: int = 9, h: int = 72, w: int = 96,
                cin: int = 3, lstm_size: int = 256) -> int:
    """ImpalaDeep: torso, LSTM over [torso, reward, one-hot action], heads."""
    return (impala_resnet_torso(h, w, cin)
            + lstm(256 + 1 + num_actions, lstm_size)
            + dense(lstm_size, num_actions) + dense(lstm_size, 1))
