"""Per-stage decomposition and FLOPs / mfu model of the DmLab x ImpalaDeep
V-trace step.

The port of ``scripts/profile_impala.py``, on the learner of
``seed_rl_torch.bench.dmlab_vtrace_learner`` (the bf16 ImpalaDeep on
synthetic 72x96x3 DmLab frames, 9 actions; ``--remat`` recomputes its
torso in the backward, ``ImpalaDeep(remat=True)``). It prints:

  1. the stage table: the full train step, the rollout only, the update
     only (loss, backward, clip and Adam) on one fixed unroll, the loss
     forward only and the loss forward and backward, and the rollout's and
     the update's shares of the full step;
  2. the torso alone at the train shape ((T+1)*B frames): forward, forward
     and backward, each residual stack's forward at its input shape, the
     Dense 3456->256 and the LSTM(256) stepped over T+1;
  3. the FLOPs model per frame (``utils/flops.py::impala_flops_per_frame``,
     the script's model) and the HBM-traffic model of the torso forward
     (``impala_hbm_bytes_per_frame``);
  4. the mfu at the measured step, and the torso forward's mfu and share of
     the memory rate, against the H100's dense bf16 peak (989 TFLOP/s: the
     torso computes in bf16) and its 3.35 TB/s (``utils/flops.py``), at
     the card's power limit printed beside them.

Rows 1's update and loss rows launch the V-trace kernel at [T, B] =
[32, 256]. Rows are timed and profiled as ``tools/_timing.py`` says.

Run:  python -m seed_rl_torch.tools.profile_impala [--device=cpu]
          [--envs=256] [--unroll=32] [--remat] [--iters=20]
"""

import argparse

import torch
import torch.nn.functional as F

from seed_rl_torch.tools import _timing
from seed_rl_torch.tools.profile_bench import loss_rows
from seed_rl_torch.utils import flops as fm

# The torso computes in bf16 (the bench's ImpalaDeep): its peak.
PEAK_FLOPS, PEAK_NAME = fm.PEAK_BF16_FLOPS, "bf16"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_device_flag(p)
    p.add_argument("--envs", type=int, default=256)
    p.add_argument("--unroll", type=int, default=32)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--iters", type=int, default=20)
    return p.parse_args(argv)


def stage_table(learner, device, iters, frames, width=46):
    """Section 1's rows, and the shares of the full step."""
    engine = learner.engine
    held = {"state": learner.init()}

    def full_step():
        held["state"] = learner.train_step(held["state"])[0]

    def rollout():
        state = held["state"]
        held["state"] = state._replace(
            rollout=engine.rollout(state.rollout)[0])

    rows = {"full": _timing.timeit("full train step", full_step, device,
                                   iters, frames, width),
            "rollout": _timing.timeit("rollout only", rollout, device, iters,
                                      frames, width)}
    _, unroll = engine.rollout(held["state"].rollout)

    def update():
        held["state"] = learner.update(held["state"], unroll)[0]

    rows["update"] = _timing.timeit("update only (loss+bwd+opt)", update,
                                    device, iters, frames, width)
    rows["loss_fwd"], rows["loss_fwd_bwd"] = loss_rows(
        learner, unroll, device, iters, frames, width)
    full = rows["full"].ms
    print(f"\nstage shares of full step: rollout "
          f"{rows['rollout'].ms / full:5.1%}  update "
          f"{rows['update'].ms / full:5.1%}  (sum "
          f"{100 * (rows['rollout'].ms + rows['update'].ms) / full:5.1f}%)")
    return rows


def torso_rows(device, n, T, B, iters, width=46):
    """Section 2: the torso and its parts alone at ``n`` frames."""
    from seed_rl_torch.models.core import LSTMCell, dense
    from seed_rl_torch.models.resnets import ImpalaResNetTorso, ResidualStack

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(0)  # parameters, on the host
    data = _timing.Data(device)
    rows = {}

    def row(key, name, fn):
        rows[key] = _timing.timeit(name, fn, device, iters, n, width)

    frames = data.frames((n, 72, 96, 3))
    torso = ImpalaResNetTorso((72, 96, 3), gen, dtype=bf16).to(device)
    params = list(torso.parameters())
    with torch.no_grad():
        row("torso_fwd", "torso fwd", lambda: torso(frames))
    row("torso_fwd_bwd", "torso fwd+bwd", lambda: torch.autograd.grad(
        torso(frames).sum(), params))
    shapes = [(72, 96, 3, 16), (36, 48, 16, 32), (18, 24, 32, 32)]
    for i, (h, w, cin, cout) in enumerate(shapes):
        x = data.randn((n, cin, h, w), bf16)
        stack = ResidualStack(cin, cout, 2, gen, dtype=bf16).to(device)
        with torch.no_grad():
            row(f"stack{i}", f"stack{i} {cin}->{cout}ch @{h}x{w}",
                lambda stack=stack, x=x: stack(x))
    xd = data.randn((n, 9 * 12 * 32), bf16)
    layer = dense(9 * 12 * 32, 256, gen).to(device, bf16)
    with torch.no_grad():
        row("dense", "dense 3456->256", lambda: F.linear(
            xd, layer.weight, layer.bias))
    xl = data.randn((T + 1, B, 266))
    cell = LSTMCell(266, 256, gen).to(device)
    cell_params = list(cell.parameters())

    def lstm_scan():
        carry = (torch.zeros((B, 256), device=device),
                 torch.zeros((B, 256), device=device))
        outs = []
        for t in range(T + 1):
            carry, out = cell(carry, xl[t])
            outs.append(out)
        return torch.stack(outs)

    with torch.no_grad():
        row("lstm_fwd", "LSTM(256) scan fwd [T+1,B]", lstm_scan)
    row("lstm_fwd_bwd", "LSTM(256) scan fwd+bwd [T+1,B]",
        lambda: torch.autograd.grad(lstm_scan().sum(), cell_params))
    return rows


def main(argv=None):
    """Returns the rows, the FLOPs model, the mfu (None on the CPU) and the
    card."""
    from seed_rl_torch.bench import dmlab_vtrace_learner

    args = parse_args(argv)
    device = _timing.device_from(args.device)
    B, T = args.envs, args.unroll
    frames = B * T
    card = _timing.card(device)
    print(f"== stage table (B={B}, T={T}, remat={args.remat}; {card}) ==")
    learner = dmlab_vtrace_learner(device, B, T, remat=args.remat)
    stages = stage_table(learner, device, args.iters, frames)

    n_train = (T + 1) * B
    print(f"\n== torso isolation ([{n_train} frames, 72x96x3]) ==")
    torso = torso_rows(device, n_train, T, B, args.iters)

    fwd_flops, detail = fm.impala_flops_per_frame()
    hbm_fwd = fm.impala_hbm_bytes_per_frame()
    print("\n== FLOPs model (per frame, forward) ==")
    for k, v in detail.items():
        print(f"  {k:16s} {v / 1e6:8.2f} MFLOP")
    print(f"  {'total fwd':16s} {fwd_flops / 1e6:8.2f} MFLOP")
    print(f"  activation HBM traffic fwd ~{hbm_fwd / 1e3:.0f} KB/frame")

    # Per env frame: the rollout's forward, and the train pass (forward +
    # backward = 3 forwards) over (T+1)/T frames.
    train_mult = (T + 1) / T
    flops_per_env_frame = fwd_flops * (1.0 + 3.0 * train_mult)
    fps_full = stages["full"].fps
    print("\n== MFU at the measured step ==")
    print(f"  fps (this config)          {fps_full / 1e3:8.1f}k")
    print(f"  FLOPs/env-frame (1 fwd + {train_mult:.2f}x(fwd+bwd))"
          f" = {flops_per_env_frame / 1e6:.1f} MFLOP")
    mfu = mfu_torso = hbm_frac = None
    if device.type != "cuda":
        print("  mfu: not measured (a CPU run; the peaks are the H100's)")
    else:
        achieved = fps_full * flops_per_env_frame
        mfu = achieved / PEAK_FLOPS
        torso_s = torso["torso_fwd"].ms / 1e3
        mfu_torso = ((fwd_flops - detail["lstm"] - detail["heads"])
                     * n_train / (torso_s * PEAK_FLOPS))
        hbm_frac = hbm_fwd * n_train / (torso_s * fm.HBM_BYTES_PER_S)
        print(f"  achieved compute           {achieved / 1e12:8.2f} TFLOP/s")
        print(f"  MFU vs {PEAK_FLOPS / 1e12:.0f} TF {PEAK_NAME} peak "
              f"(H100 SXM5 data sheet)   {mfu:8.2%}")
        print(f"  torso-fwd MFU              {mfu_torso:8.2%}")
        print(f"  torso-fwd HBM fraction     {hbm_frac:8.2%} of "
              f"{fm.HBM_BYTES_PER_S / 1e9:.0f} GB/s")
    print(card, flush=True)
    return {"stages": stages, "torso": torso, "flops_per_frame": fwd_flops,
            "flops_detail": detail, "hbm_bytes_per_frame": hbm_fwd,
            "flops_per_env_frame": flops_per_env_frame, "mfu": mfu,
            "mfu_torso": mfu_torso, "hbm_fraction_torso": hbm_frac,
            "peak": PEAK_NAME, "card": card}


if __name__ == "__main__":
    main()
