"""Training entry point: ``python -m seed_rl_torch.train --agent=vtrace ...``.

Port of the ``--agent=vtrace --env={toy,toy_memory}`` path of
``seed_rl_tpu/train.py``, with the same flag names and defaults, plus
``--device`` (default: the CUDA device; ``--device=cpu`` runs on the CPU).
Other agents, envs, run modes, checkpoints and observation normalization
are not ported yet and raise ``NotImplementedError`` rather than being
ignored.

Example (the README's quick-start config):
  python -m seed_rl_torch.train --agent=vtrace --env=toy \
      --num_envs=64 --unroll_length=10 --total_environment_frames=200000
"""

import argparse
import functools
import math

from seed_rl_torch.device import resolve_device

# The JAX CLI's choices, so every spelling it accepts is recognised here and
# refused by name until ported.
AGENTS = ["vtrace", "ppo", "r2d2", "sac"]
ENVS = [
    "toy", "toy_memory", "discrete_match", "bit_flipping", "synthetic_atari",
    "synthetic_atari_host", "catch", "catch_continuous", "mujoco", "atari",
    "dmlab", "football",
]
RUN_MODES = ["train", "eval", "profile", "actor", "learner"]
PORTED_AGENTS = ("vtrace",)
PORTED_ENVS = ("toy", "toy_memory")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--agent", required=True, choices=AGENTS)
    p.add_argument("--run_mode", default="train", choices=RUN_MODES)
    p.add_argument("--env", required=True, choices=ENVS)
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA device")
    p.add_argument("--logdir", default=None)
    p.add_argument("--total_environment_frames",
                   type=lambda s: int(float(s)), default=1_000_000)
    p.add_argument("--num_envs", type=int, default=64)
    p.add_argument("--unroll_length", type=int, default=20)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--lr_decay_multiplier", type=float, default=1.0,
                   help="linear lr decay to lr_decay_multiplier*lr over "
                        "the frame budget (1.0 = constant lr)")
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--clip_norm", type=float, default=40.0)
    p.add_argument("--discounting", type=float, default=0.99)
    p.add_argument("--entropy_cost", type=float, default=2.5e-4)
    p.add_argument("--init_checkpoint", default=None)
    p.add_argument("--steps_per_call", type=int, default=10)
    p.add_argument("--log_every_steps", type=int, default=20)
    p.add_argument("--normalize_observations", action="store_true")
    return p.parse_args(argv)


def _refuse_unported(args):
    def refuse(what):
        raise NotImplementedError(
            f"{what} is not ported to seed_rl_torch yet; use "
            "python -m seed_rl_tpu.train (see ROADMAP.md queue A)"
        )

    if args.agent not in PORTED_AGENTS:
        refuse(f"--agent={args.agent}")
    if args.env not in PORTED_ENVS:
        refuse(f"--env={args.env}")
    if args.run_mode != "train":
        refuse(f"--run_mode={args.run_mode}")
    if args.logdir is not None:
        refuse("--logdir (checkpoints and TensorBoard logs)")
    if args.init_checkpoint is not None:
        refuse("--init_checkpoint")
    if args.normalize_observations:
        refuse("--normalize_observations")


def make_env(args, device):
    from seed_rl_torch import envs

    env = envs.ToyEnv() if args.env == "toy" else envs.ToyMemoryEnv()
    return envs.BatchedEnv(env, args.num_envs, device=device, seed=0)


def main(argv=None):
    """Trains; returns (learner, final train state, last metrics)."""
    args = parse_args(argv)
    _refuse_unported(args)
    device = resolve_device(args.device)

    from seed_rl_torch import distributions as pd
    from seed_rl_torch import optim
    from seed_rl_torch.agent import PolicyAgent
    from seed_rl_torch.agents import vtrace as vtrace_agent
    from seed_rl_torch.models import MLPAndLSTM
    from seed_rl_torch.rollout import RolloutEngine
    from seed_rl_torch.utils.metrics import MetricsLogger

    env = make_env(args, device)
    # Linear decay over optimizer updates (one per V-trace step), the
    # reference's PolynomialDecay with power 1.
    frames_per_rollout = max(1, args.num_envs * args.unroll_length)
    rollouts = max(1, args.total_environment_frames // frames_per_rollout)
    decay = args.lr_decay_multiplier != 1.0
    optimizer = functools.partial(
        optim.ClippedAdam,
        learning_rate=args.learning_rate,
        clip_norm=args.clip_norm,
        b1=args.adam_beta1,
        eps=args.adam_epsilon,
        end_learning_rate=(
            args.lr_decay_multiplier * args.learning_rate if decay else None
        ),
        transition_steps=rollouts,
    )

    dist = pd.get_parametric_distribution_for_action_space(env.action_space)
    net = MLPAndLSTM(
        parametric_distribution_param_size=dist.param_size,
        input_size=math.prod(env.observation_spec().shape),
        seed=0,
        device=device,
    )
    agent = PolicyAgent(net, dist)
    config = vtrace_agent.VTraceConfig(
        discounting=args.discounting,
        entropy_cost=args.entropy_cost,
    )
    engine = RolloutEngine(env, agent, args.unroll_length, seed=1)
    learner = vtrace_agent.VTraceLearner(
        engine, agent, config, optimizer, seed=2
    )
    state, metrics = vtrace_agent.learner_loop(
        learner,
        args.total_environment_frames,
        logger=MetricsLogger(),
        log_every_steps=args.log_every_steps,
        steps_per_call=args.steps_per_call,
    )
    return learner, state, metrics


if __name__ == "__main__":
    main()
