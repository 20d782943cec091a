"""Deterministic-policy evaluation.

Port of ``seed_rl_tpu/evaluation.py::run_eval``: roll the env fleet
forward with the policy's mode instead of samples, in chunks of
``unroll_length`` steps, until ``num_episodes`` episodes have completed,
and report their mean return and length. On a ``BatchedEnv`` the env's
generator is reseeded from ``seed`` first; host envs (``host=True``, a
``HostBatchedEnv``) are reset with seed ``0 + i``, as the JAX package
resets them. Either way the same seed and parameters replay the same
episodes.
"""

from typing import Dict

import torch.utils._pytree as pytree

from seed_rl_torch.rollout import RolloutEngine
from seed_rl_torch.utils import episode_stats


def run_eval(
    env,
    agent,
    num_episodes: int,
    unroll_length: int = 32,
    max_rounds: int = 1000,
    seed: int = 0,
    host: bool = False,
    device=None,
) -> Dict[str, float]:
    """Runs deterministic inference until ``num_episodes`` complete.

    Args:
      env: a ``BatchedEnv`` on the agent's device, or with ``host`` a
        ``HostBatchedEnv``.
      agent: any agent whose ``policy_step`` takes ``deterministic``.
      num_episodes: minimum completed episodes to aggregate.
      unroll_length: env steps per chunk.
      max_rounds: safety bound on chunks.
      seed: reseeds a ``BatchedEnv``'s generator (and the engine's, unused
        here).
      host: ``env`` steps on the host.
      device: the agent's device, with ``host`` (default: the CUDA device).

    Returns:
      dict with eval/num_episodes, eval/mean_return, eval/mean_length.
    """
    if host:
        from seed_rl_torch.rollout_host import HostRolloutEngine

        engine = HostRolloutEngine(env, agent, unroll_length, device=device,
                                   seed=seed, deterministic=True)
    else:
        env.generator.manual_seed(seed)
        engine = RolloutEngine(env, agent, unroll_length, seed=seed,
                               deterministic=True)
    state = engine.init()
    stats = episode_stats.init(env.num_envs, engine.device)
    rounds = 0
    while float(stats.num_episodes) < num_episodes and rounds < max_rounds:
        state, unroll = engine.rollout(state)
        new = pytree.tree_map(lambda x: x[1:], unroll.timesteps.env_output)
        stats = episode_stats.update(stats, new)
        rounds += 1

    n = max(float(stats.num_episodes), 1.0)
    return {
        "eval/num_episodes": float(stats.num_episodes),
        "eval/mean_return": float(stats.sum_return) / n,
        "eval/mean_length": float(stats.sum_length) / n,
    }
