"""Per-env episode accounting, on the device.

Port of ``seed_rl_tpu/utils/episode_stats.py``: per-env return accumulators
reset on done, and completed episodes reduced to windowed sums without a
host round-trip per episode.
"""

from typing import NamedTuple

import torch

from seed_rl_torch.types import EnvOutput


class EpisodeStatsState(NamedTuple):
    return_acc: torch.Tensor  # f32[B] running episode return
    # Windowed sums over completed episodes (reset by the caller when logged).
    num_episodes: torch.Tensor  # f32[]
    sum_return: torch.Tensor  # f32[]
    sum_length: torch.Tensor  # f32[]


def init(num_envs: int, device=None) -> EpisodeStatsState:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return EpisodeStatsState(
        return_acc=zeros(num_envs),
        num_episodes=zeros(),
        sum_return=zeros(),
        sum_length=zeros(),
    )


def update(
    state: EpisodeStatsState, env_outputs: EnvOutput
) -> EpisodeStatsState:
    """Consume a time-major [T, B] EnvOutput block of NEW timesteps.

    The block must contain each env step exactly once (pass
    ``unroll.timesteps.env_output`` sliced to the new steps, i.e. excluding
    the overlap prefix).
    """
    return_acc, num_ep, sum_ret, sum_len = state
    for t in range(env_outputs.reward.shape[0]):
        return_acc = return_acc + env_outputs.reward[t]
        done = env_outputs.done[t]
        done_f = done.to(torch.float32)
        num_ep = num_ep + torch.sum(done_f)
        sum_ret = sum_ret + torch.sum(done_f * return_acc)
        sum_len = sum_len + torch.sum(
            done_f * env_outputs.episode_step[t].to(torch.float32)
        )
        return_acc = torch.where(done, torch.zeros_like(return_acc),
                                 return_acc)
    return EpisodeStatsState(return_acc, num_ep, sum_ret, sum_len)


def reset_window(state: EpisodeStatsState) -> EpisodeStatsState:
    """Clear the completed-episode window (keep per-env accumulators)."""
    zero = torch.zeros_like(state.num_episodes)
    return EpisodeStatsState(
        return_acc=state.return_acc,
        num_episodes=zero,
        sum_return=zero,
        sum_length=zero,
    )
