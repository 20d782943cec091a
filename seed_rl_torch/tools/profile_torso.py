"""The Atari torso, the LSTM and frame stacking, each alone, at the bench
shape T = 32, B = 1024.

The port of ``scripts/profile_torso.py``. Rows, as the script's:

  - the bf16 ``AtariConvTorso`` (4 stacked 84x84 frames) forward, and its
    forward and backward (gradient of the summed output in the
    parameters), over T*B frames;
  - ``stack_frames_time_major`` over a [T, B] unroll of 84x84x1 frames;
  - the LSTM(256) core stepped over T on [B, 531] inputs (the torso's 512
    features, the reward and 18 one-hot actions), forward and forward +
    backward (the port's ``LSTMCell``, f32 as in the script);
  - each conv alone at T*B in bf16 (4->32 k8s4 at 84, 32->64 k4s2 at 20,
    64->64 k3s1 at 9), conv1 as a space-to-depth 64->32 k2s1 conv at 21,
    and the Dense 3136->512.

This path runs no kernel of the port. Each row is timed and profiled as
``tools/_timing.py`` says.

Run:  python -m seed_rl_torch.tools.profile_torso [--device=cpu]
          [--B=1024] [--iters=30]
"""

import argparse

import torch
import torch.nn.functional as F

from seed_rl_torch.tools import _timing

T = 32  # the unroll


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_device_flag(p)
    p.add_argument("--B", type=int, default=1024)
    p.add_argument("--iters", type=int, default=30)
    return p.parse_args(argv)


def main(argv=None):
    """Returns the rows (``_timing.Row``) and the card."""
    from seed_rl_torch.models.atari import (
        AtariConvTorso,
        stack_frames_time_major,
    )
    from seed_rl_torch.models.core import LSTMCell, conv, dense

    args = parse_args(argv)
    device = _timing.device_from(args.device)
    B = args.B
    n = T * B
    gen = torch.Generator().manual_seed(0)  # parameters, on the host
    data = _timing.Data(device)

    def row(name, fn):
        return _timing.timeit(name, fn, device, args.iters, n, 44)

    bf16 = torch.bfloat16
    rows = []
    frames = data.frames((n, 84, 84, 4))
    torso = AtariConvTorso(4, (84, 84), gen, dtype=bf16).to(device)
    params = list(torso.parameters())
    with torch.no_grad():
        rows.append(row("torso fwd [T*B]", lambda: torso(frames)))
    rows.append(row("torso fwd+bwd [T*B]", lambda: torch.autograd.grad(
        torso(frames).sum(), params)))

    obs_seq = data.frames((T, B, 84, 84, 1))
    done_seq = torch.zeros((T, B), dtype=torch.bool, device=device)
    history = torch.zeros((B, 84, 84, 3), dtype=torch.uint8, device=device)
    rows.append(row("frame stacking scan [T,B]",
                    lambda: stack_frames_time_major(obs_seq, history,
                                                    done_seq, 4)[0]))

    x = data.randn((T, B, 531))
    cell = LSTMCell(531, 256, gen).to(device)
    cell_params = list(cell.parameters())

    def lstm_scan():
        carry = (torch.zeros((B, 256), device=device),
                 torch.zeros((B, 256), device=device))
        outs = []
        for t in range(T):
            carry, out = cell(carry, x[t])
            outs.append(out)
        return torch.stack(outs)

    with torch.no_grad():
        rows.append(row("LSTM(256) scan fwd [T,B]", lstm_scan))
    rows.append(row("LSTM(256) scan fwd+bwd [T,B]",
                    lambda: torch.autograd.grad(lstm_scan().sum(),
                                                cell_params)))

    def one_conv(name, cout, k, s, cin, hw):
        inputs = data.randn((n, cin, hw, hw), bf16)
        layer = conv(cin, cout, k, s, 0, gen).to(device, bf16)
        with torch.no_grad():
            rows.append(row(name, lambda: F.conv2d(
                inputs, layer.weight, layer.bias, layer.stride)))

    one_conv("conv 4->32 k8s4 @84", 32, 8, 4, 4, 84)
    one_conv("conv 32->64 k4s2 @20", 64, 4, 2, 32, 20)
    one_conv("conv 64->64 k3s1 @9", 64, 3, 1, 64, 9)
    one_conv("conv1 as s2d 64->32 k2s1 @21", 32, 2, 1, 64, 21)

    xd = data.randn((n, 3136), bf16)
    layer = dense(3136, 512, gen).to(device, bf16)
    with torch.no_grad():
        rows.append(row("dense 3136->512", lambda: F.linear(
            xd, layer.weight, layer.bias)))
    card = _timing.card(device)
    print(card, flush=True)
    return {"rows": rows, "card": card}


if __name__ == "__main__":
    main()
