"""Stage breakdown of the V-trace x AtariPolicyNet bench step on the card.

The port of ``scripts/profile_bench.py``, at its shape: 1024 envs x unroll
32, the bf16 AtariPolicyNet (LSTM 256) on synthetic 84x84 Atari frames
(``seed_rl_torch.bench.vtrace_atari_learner``). Rows, as the script's:

  - the full train step (rollout, then the V-trace update);
  - the rollout only;
  - the update only (loss, backward, clip and Adam) on one fixed unroll;
  - the loss forward only, on one fixed unroll (no autograd graph);
  - the loss forward and backward on it (the gradient of every parameter).

Every row but the rollout launches the V-trace kernel
(``csrc/vtrace_kernel.cu``) at [32, 1024]. Each row is timed as
``tools/_timing.py`` says (synchronized host clock, ``--iters`` calls
after a warm-up call) and, on the card, profiled for its device busy ms,
kernel launches and idle share.

Run:  python -m seed_rl_torch.tools.profile_bench [--device=cpu]
          [--num_envs=1024] [--iters=20]
"""

import argparse

import torch

from seed_rl_torch.tools import _timing

UNROLL = 32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_device_flag(p)
    p.add_argument("--num_envs", type=int, default=1024)
    p.add_argument("--iters", type=int, default=20)
    return p.parse_args(argv)


def loss_rows(learner, unroll, device, iters, frames, width=40):
    """The loss forward alone and its forward and backward, on ``unroll``."""
    from seed_rl_torch.agents import vtrace

    agent = learner.agent

    def loss():
        return vtrace.compute_loss(learner.config, agent, agent.distribution,
                                   learner.entropy_cost, unroll,
                                   learner.generator)[0]

    def forward():
        with torch.no_grad():
            return loss()

    def backward():
        return torch.autograd.grad(loss(), learner.parameters())

    return [
        _timing.timeit("loss forward", forward, device, iters, frames,
                       width),
        _timing.timeit("loss fwd+bwd", backward, device, iters, frames,
                       width),
    ]


def main(argv=None):
    """Returns the rows (``_timing.Row``) and the card."""
    from seed_rl_torch.bench import vtrace_atari_learner

    args = parse_args(argv)
    device = _timing.device_from(args.device)
    frames = args.num_envs * UNROLL
    learner = vtrace_atari_learner(device, args.num_envs, UNROLL)
    engine = learner.engine
    held = {"state": learner.init()}

    def full_step():
        held["state"] = learner.train_step(held["state"])[0]

    def rollout():
        state = held["state"]
        held["state"] = state._replace(
            rollout=engine.rollout(state.rollout)[0])

    rows = [_timing.timeit("full train_step", full_step, device, args.iters,
                           frames, 40),
            _timing.timeit("rollout only", rollout, device, args.iters,
                           frames, 40)]
    _, unroll = engine.rollout(held["state"].rollout)

    def update():
        held["state"] = learner.update(held["state"], unroll)[0]

    rows.append(_timing.timeit("update only", update, device, args.iters,
                               frames, 40))
    rows += loss_rows(learner, unroll, device, args.iters, frames)
    card = _timing.card(device)
    print(card, flush=True)
    return {"rows": rows, "card": card}


if __name__ == "__main__":
    main()
