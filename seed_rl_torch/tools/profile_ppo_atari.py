"""Decomposition of the conv-PPO bench step.

The port of ``scripts/profile_ppo_atari.py``, at its shape: 256 envs x
unroll 32, the bf16 AtariPolicyNet (conv torso, LSTM 256) on synthetic
84x84 Atari frames, GAE 0.95, PPO clip 0.2, PopArt, entropy 0.01, shuffle
mode, 2 epochs x 8 minibatches (``make_learner``, through
``seed_rl_torch.bench.ppo_atari_learner``). Rows, as the script's:

  - the full train step (rollout + update);
  - the rollout only;
  - the update only (the epochs on one fixed unroll), in shuffle mode
    (2 x 8), repeat mode (2 x 8, no gather), repeat 1 x 1 (one forward and
    backward over the whole batch) and repeat 1 x 8;
  - the shuffle mode's 16 minibatch gathers alone, [33, 32, ...] column
    subsets of the [33, 256, 84, 84, 1] uint8 frames and the small leaves,
    through ``utils/tree.py::take`` (C6's signed view for uint16), and the
    same gathers of the frames flattened to [33, 256, 84*84] first.

Each row is timed and profiled as ``tools/_timing.py`` says; on the card a
row also prints its kernel launches, the lever PERF.md section 7 names
for PPO. No kernel of the port is on this path (the PPO advantage
estimators are plain PyTorch).

Run:  python -m seed_rl_torch.tools.profile_ppo_atari [--device=cpu]
          [--num_envs=256] [--unroll=32] [--iters=20]
"""

import argparse

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.tools import _timing

NUM_ENVS, UNROLL = 256, 32


def make_learner(batch_mode, epochs, batches, num_envs=NUM_ENVS,
                 unroll=UNROLL, device="cuda"):
    """The script's learner (``make_learner``); returns it and its
    engine."""
    from seed_rl_torch.bench import ppo_atari_learner

    learner = ppo_atari_learner(torch.device(device), num_envs, unroll,
                                batch_mode, epochs, batches)
    return learner, learner.engine


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_device_flag(p)
    p.add_argument("--num_envs", type=int, default=NUM_ENVS)
    p.add_argument("--unroll", type=int, default=UNROLL)
    p.add_argument("--iters", type=int, default=20)
    return p.parse_args(argv)


def main(argv=None):
    """Returns the rows (``_timing.Row``, by name) and the card."""
    from seed_rl_torch.utils.tree import take

    args = parse_args(argv)
    device = _timing.device_from(args.device)
    B, T = args.num_envs, args.unroll
    frames = B * T
    rows = {}

    def row(name, fn):
        rows[name] = _timing.timeit(name, fn, device, args.iters, frames, 44)
        return rows[name]

    def learner(mode, epochs, batches):
        return make_learner(mode, epochs, batches, B, T, device)[0]

    shuffle = learner("shuffle", 2, 8)
    held = {"state": shuffle.init()}

    def full_step():
        held["state"] = shuffle.train_step(held["state"])[0]

    def rollout():
        state = held["state"]
        held["state"] = state._replace(
            rollout=shuffle.engine.rollout(state.rollout)[0])

    t_full = row("full step (shuffle 2ep x 8mb)", full_step).ms
    t_ro = row("rollout only", rollout).ms
    _, unroll = shuffle.engine.rollout(held["state"].rollout)

    def update_only(lrn):
        states = {"state": lrn.init()}

        def run():
            states["state"] = lrn.update(states["state"], unroll)[0]

        return run

    t_upd = row("update only (shuffle 2ep x 8mb)", update_only(shuffle)).ms
    t_rep = row("update only (repeat 2ep x 8mb, no gather)",
                update_only(learner("repeat", 2, 8))).ms
    t_one = row("update only (repeat 1ep x 1mb = 1 fwd+bwd)",
                update_only(learner("repeat", 1, 1))).ms
    row("update only (repeat 1ep x 8mb)", update_only(learner("repeat", 1,
                                                              8)))

    ts = unroll.timesteps
    data = (ts.prev_action, ts.env_output, ts.agent_output)
    flat = (ts.prev_action, ts.env_output.observation.reshape(T + 1, B, -1),
            ts.agent_output)
    generator = torch.Generator(device=device).manual_seed(2)
    mb = B // 8

    def gathers(tree):
        def run():
            for _ in range(2):
                perm = torch.randperm(B, generator=generator, device=device)
                for i in range(8):
                    pytree.tree_leaves(take(tree, perm[i * mb:(i + 1) * mb],
                                            dim=1))
        return run

    row("16 minibatch gathers (take axis=1)", gathers(data))
    row("16 minibatch gathers (flattened obs)", gathers(flat))
    print("-" * 60)
    print(f"decomposition: rollout {t_ro:.1f} + update {t_upd:.1f} "
          f"vs full {t_full:.1f} ms")
    print(f"shuffle-vs-repeat update delta (gather cost): "
          f"{t_upd - t_rep:.1f} ms")
    print(f"epoch scaling: 1x1 {t_one:.1f} -> 2x8 repeat {t_rep:.1f} ms")
    card = _timing.card(device)
    print(card, flush=True)
    return {"rows": rows, "card": card}


if __name__ == "__main__":
    main()
