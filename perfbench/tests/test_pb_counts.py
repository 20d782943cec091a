"""The frozen FLOP and byte counts against hand-derived values."""

import pytest

from perfbench.counts import bounds, flops


def test_one_conv_forward_and_backward():
    # 3x3 SAME, 16 -> 16 channels at 36x48, 8448 frames, bf16.
    conv = bounds.Conv(36, 48, 16, 16, 3, 36, 48, False)
    n = 8448
    ops = 2 * n * 36 * 48 * 16 * 16 * 9
    act = n * 36 * 48 * 16 * 2  # one activation, bf16
    wgt = (16 * 16 * 9 + 16) * 2
    one = max(ops / 989e12, (2 * act + wgt) / 3.35e12)
    assert one == (2 * act + wgt) / 3.35e12  # bound by its bytes
    assert bounds.conv_seconds(conv, n, train=False) == pytest.approx(one)
    # The backward: dx and dw, each with the forward's bytes and FLOPs.
    assert bounds.conv_seconds(conv, n, train=True) == pytest.approx(3 * one)
    first = conv._replace(first=True)  # its input is the frames: no dx
    assert bounds.conv_seconds(first, n, train=True) == pytest.approx(2 * one)


def test_impala_torso_flops_by_hand():
    # Stack 1: 3->16 at 72x96, then 4 convs 16->16 at 36x48; stack 2:
    # 16->32 at 36x48, 4 x 32->32 at 18x24; stack 3: 32->32 at 18x24,
    # 4 x 32->32 at 9x12; Dense 9*12*32 -> 256.
    by_hand = (2 * 9 * (72 * 96 * 3 * 16 + 4 * 36 * 48 * 16 * 16
                        + 36 * 48 * 16 * 32 + 4 * 18 * 24 * 32 * 32
                        + 18 * 24 * 32 * 32 + 4 * 9 * 12 * 32 * 32))
    by_hand += 2 * 9 * 12 * 32 * 256
    assert flops.impala_resnet_torso(72, 96, 3) == by_hand
    lstm = 2 * 4 * (256 + 1 + 9 + 256) * 256
    heads = 2 * 256 * 9 + 2 * 256
    assert flops.impala_deep(9) == by_hand + lstm + heads
    convs = bounds.impala_convs(72, 96, 3)
    assert len(convs) == 15 and convs[0].first and not convs[1].first
    assert [(c.h, c.w, c.cin, c.cout) for c in convs[:2]] == [
        (72, 96, 3, 16), (36, 48, 16, 16)]


def test_nature_torso_by_hand():
    convs = bounds.nature_convs(84, 84, 4)
    assert [(c.oh, c.ow) for c in convs] == [(20, 20), (9, 9), (7, 7)]
    by_hand = 2 * (20 * 20 * 32 * 4 * 64 + 9 * 9 * 64 * 32 * 16
                   + 7 * 7 * 64 * 64 * 9 + 3136 * 512)
    assert flops.nature_torso() == by_hand


def test_kernel_bounds_match_the_kernel_table():
    # PERF.md's table of kernels: B1 [32, 1024] 0.000275 ms, B2 [81, 64]
    # 0.0000263 ms and [81, 610] 0.000251 ms, all bound by their bytes.
    assert bounds.vtrace_seconds(32, 1024) * 1e3 == pytest.approx(
        (5 * 32 + 1 + 2 * 32) * 1024 * 4 / 3.35e12 * 1e3)
    assert bounds.vtrace_seconds(32, 1024) * 1e3 == pytest.approx(
        0.000275, rel=2e-3)
    assert bounds.nstep_seconds(81, 64) * 1e3 == pytest.approx(
        0.0000263, rel=2e-3)
    assert bounds.nstep_seconds(81, 610) * 1e3 == pytest.approx(
        0.000251, rel=2e-3)
