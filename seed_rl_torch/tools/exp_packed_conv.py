"""Spatial output packing for ImpalaDeep's narrow 3x3 convs, A/B.

The port of ``scripts/exp_packed_conv.py``. A 3x3 SAME conv of ``cout``
output channels is computed three ways, forward only, bf16, at n = 8448
frames (33 x 256, the DmLab train shape), at the five conv shapes of
ImpalaDeep's stacks:

- ``plain``: ``conv2d(x, w, padding=1)``;
- ``packed 1d P``: P neighbouring output pixels of a row folded into the
  output channels, ordered (p, c): the kernel covers the union of their
  windows, (3, P + 2), at stride (1, P), so

      y[n, c, i, P * jb + p] = Y[n, (p, c), i, jb],
      W'[(p, c), ci, di, t] = w[c, ci, di, t - p]  (0 <= t - p < 3, else 0)

  and the FLOPs are (P + 2) / 3 times the plain conv's;
- ``packed 2d ph x pw``: a ph x pw block folded the same way, kernel
  (ph + 2, pw + 2) at stride (ph, pw), (ph + 2)(pw + 2) / 9 times the
  FLOPs.

On the TPU the packing filled the MXU's 128 lanes; on the H100 the
question is whether cuDNN runs the narrow convs far from their bound and
whether packing changes that. Inputs are channels_last, as the torso runs
(``models/resnets.py``): the 1-D form's unpacking ``[N, H, W/P, P*cout]
-> [N, H, W, cout]`` is then a view, while the 2-D form's transpose is a
copy, as in the JAX script. Each conv pads with its own ``padding=1``
(the pad is symmetric), not a padded copy of the input.

Each row is timed and profiled as ``tools/_timing.py`` says and printed
beside its bound: the larger of its bytes (input, output and weight, each
once) at the card's memory rate and its FLOPs at the bf16 peak
(``utils/flops.py``), with the share of that bound the row reaches. The
speedups and the max |packed - plain| (computed on the device) follow, as
the script prints them. This path runs no kernel of the port.

Run:  python -m seed_rl_torch.tools.exp_packed_conv [--device=cpu]
          [--n=8448] [--iters=30]
"""

import argparse
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from seed_rl_torch.tools import _timing
from seed_rl_torch.utils import flops

BF16 = torch.bfloat16


class Shape(NamedTuple):
    """One conv of the torso: height x width, in -> out channels, the 1-D
    pack and the 2-D pack (rows, columns)."""

    h: int
    w: int
    cin: int
    cout: int
    pack: int
    pack2d: Tuple[int, int]
    tag: str


# The script's shapes and packs, in its order (scripts/exp_packed_conv.py
# main; its 1-D packs are 128 lanes // cout, the last one 4).
SHAPES = (
    Shape(36, 48, 16, 16, 8, (2, 4), "stack0 res conv"),
    Shape(72, 96, 3, 16, 8, (2, 4), "stack0 downscale"),
    Shape(18, 24, 32, 32, 4, (2, 2), "stack1 res conv"),
    Shape(36, 48, 16, 32, 4, (2, 2), "stack1 downscale"),
    Shape(9, 12, 32, 32, 4, (1, 4), "stack2 res conv"),
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_device_flag(p)
    p.add_argument("--n", type=int, default=8448)
    p.add_argument("--iters", type=int, default=30)
    return p.parse_args(argv)


def plain_conv(x, w):
    """x [N, cin, H, W], w [cout, cin, 3, 3] -> the SAME conv."""
    return F.conv2d(x, w, padding=1)


def make_packed_kernel_1d(w, pack):
    """w [cout, cin, 3, 3] -> W' [pack * cout, cin, 3, pack + 2]."""
    cout, cin, kh, kw = w.shape
    wp = w.new_zeros((pack, cout, cin, kh, pack + kw - 1))
    for p in range(pack):
        wp[p, :, :, :, p:p + kw] = w
    return wp.reshape(pack * cout, cin, kh, pack + kw - 1)


def packed_conv_1d(x, wp, pack, cout):
    """The SAME 3x3 conv of a channels_last x through the width-packed
    kernel; [N, cout, H, W] channels_last, a view of the conv's output."""
    n, _, h, w = x.shape
    if w % pack:
        raise ValueError(f"width {w} is not a multiple of the pack {pack}")
    y = F.conv2d(x, wp, stride=(1, pack), padding=1)
    # [N, H, W/P, (P, cout)] in memory -> [N, H, W, cout]: a view (which
    # raises unless the conv's output is channels_last).
    return y.permute(0, 2, 3, 1).view(n, h, w, cout).permute(0, 3, 1, 2)


def make_packed_kernel_2d(w, ph, pw):
    """w [cout, cin, 3, 3] -> W' [ph * pw * cout, cin, ph + 2, pw + 2]."""
    cout, cin, kh, kw = w.shape
    wp = w.new_zeros((ph, pw, cout, cin, ph + kh - 1, pw + kw - 1))
    for p in range(ph):
        for q in range(pw):
            wp[p, q, :, :, p:p + kh, q:q + kw] = w
    return wp.reshape(ph * pw * cout, cin, ph + kh - 1, pw + kw - 1)


def packed_conv_2d(x, wp, ph, pw, cout):
    """The SAME 3x3 conv through the block-packed kernel; [N, cout, H, W]
    channels_last (the block transpose is a copy)."""
    n, _, h, w = x.shape
    if h % ph or w % pw:
        raise ValueError(f"{h}x{w} is not a multiple of the pack {ph}x{pw}")
    y = F.conv2d(x, wp, stride=(ph, pw), padding=1)
    y = y.permute(0, 2, 3, 1).reshape(n, h // ph, w // pw, ph, pw, cout)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, cout)
    return y.permute(0, 3, 1, 2)


def conv_cost(x_shape, w_shape, y_shape, itemsize=2) -> Tuple[int, int]:
    """(bytes, FLOPs) of a conv of input, weight and output of these shapes
    (NCHW, OIHW, NCHW; the stride is in the output's): each tensor moved
    once, 2 FLOPs a multiply-accumulate."""
    nbytes = sum(math.prod(s) for s in (x_shape, w_shape, y_shape)) * (
        itemsize)
    cout, cin, kh, kw = w_shape
    n, _, oh, ow = y_shape
    return nbytes, n * flops.conv2d(oh, ow, cin, cout, 1) * kh * kw


def bound(nbytes: int, ops: int) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes at its memory rate and the FLOPs at its bf16
    peak."""
    bytes_ms = nbytes / flops.HBM_BYTES_PER_S * 1e3
    ops_ms = ops / flops.PEAK_BF16_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                          "operations")


def max_abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bench_shape(shape: Shape, n: int, data: _timing.Data, device, iters):
    """The three rows of one shape, their bounds, speedups and errors."""
    s = shape
    x = data.randn((n, s.cin, s.h, s.w), BF16)
    wgt = data.randn((s.cout, s.cin, 3, 3), BF16) * 0.05
    ph, pw = s.pack2d
    # The packed weights channels_last too, as the plain one is.
    wp1 = make_packed_kernel_1d(wgt, s.pack).contiguous(
        memory_format=torch.channels_last)
    wp2 = make_packed_kernel_2d(wgt, ph, pw).contiguous(
        memory_format=torch.channels_last)
    print(f"-- conv {s.cin}->{s.cout} @{s.h}x{s.w} ({s.tag}) --")
    forms = {
        "plain": ("plain", lambda: plain_conv(x, wgt), wgt, (1, 1)),
        "packed_1d": (f"packed 1d P={s.pack} (kernel 3x{s.pack + 2})",
                      lambda: packed_conv_1d(x, wp1, s.pack, s.cout), wp1,
                      (1, s.pack)),
        "packed_2d": (f"packed 2d {ph}x{pw} (kernel {ph + 2}x{pw + 2})",
                      lambda: packed_conv_2d(x, wp2, ph, pw, s.cout), wp2,
                      (ph, pw)),
    }
    rows, bounds, outs = {}, {}, {}
    with torch.no_grad():
        for key, (name, fn, weight, (sh, sw)) in forms.items():
            rows[key] = _timing.timeit(name, fn, device, iters, width=52)
            outs[key] = fn()
            ms, by = bound(*conv_cost(
                x.shape, weight.shape,
                (n, weight.shape[0], s.h // sh, s.w // sw), x.element_size()))
            share = (None if device.type != "cuda" or rows[key].busy_ms is
                     None else ms / rows[key].busy_ms)
            bounds[key] = {"ms": ms, "by": by, "share": share}
            print(f"   bound {ms:8.4f} ms ({by})"
                  + ("" if share is None else
                     f", the row at {share:.3f} of it (device busy)"))
    err1 = max_abs_err(outs["packed_1d"], outs["plain"])
    err2 = max_abs_err(outs["packed_2d"], outs["plain"])
    plain_ms = rows["plain"].ms
    speedup1 = plain_ms / rows["packed_1d"].ms
    speedup2 = plain_ms / rows["packed_2d"].ms
    print(f"   speedup 1d {speedup1:.2f}x (maxerr {err1:.2e}), "
          f"2d {speedup2:.2f}x (maxerr {err2:.2e})", flush=True)
    return {"rows": rows, "bounds": bounds, "speedup_1d": speedup1,
            "speedup_2d": speedup2, "max_err_1d": err1, "max_err_2d": err2,
            "plain_max_abs": float(outs["plain"].float().abs().max())}


def main(argv=None):
    """Returns each shape's rows, bounds, speedups and errors, and the
    card."""
    args = parse_args(argv)
    device = _timing.device_from(args.device)
    card = _timing.card(device)
    data = _timing.Data(device)
    print(f"== 3x3 SAME convs, plain vs packed, bf16, n={args.n} "
          f"({card}) ==")
    shapes = {f"{s.cin}->{s.cout} @{s.h}x{s.w}": bench_shape(
        s, args.n, data, device, args.iters) for s in SHAPES}
    print(card, flush=True)
    return {"shapes": shapes, "card": card}


if __name__ == "__main__":
    main()
