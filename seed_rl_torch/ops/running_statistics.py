"""Running mean/std trackers as pure state-transition functions.

Port of ``seed_rl_tpu/ops/running_statistics.py``: ``EMAMeanStd``,
``AverageMeanStd`` (Welford batch updates, with ``merge`` and ``reset``),
``FixedMeanStd`` and ``TwoLevelAverageMeanStd`` (a periodically flushed
buffer level that keeps float32 precision over long runs).

Each tracker is a stateless object: ``init_state(size, device) -> state``,
``update(state, data) -> state`` and ``mean_std(state) -> (mean, std)``;
``data`` is ``[..., size]`` and reduced over all leading dims (and over
every rank's share under ``parallel.collectives.over``). States are
NamedTuples of tensors, made anew by each update.
"""

from typing import NamedTuple, Tuple

import torch

from seed_rl_torch.parallel import collectives


def _reduce_dims(data: torch.Tensor) -> Tuple[int, ...]:
    return tuple(range(data.dim() - 1))


class MeanStd:
    """Base: normalize/unnormalize in terms of mean_std(state)."""

    def init_state(self, size: int, device=None):
        raise NotImplementedError

    def update(self, state, data):
        raise NotImplementedError

    def mean_std(self, state) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def normalize(self, state, x):
        mean, std = self.mean_std(state)
        return (x - mean) / std

    def unnormalize(self, state, x):
        mean, std = self.mean_std(state)
        return std * x + mean


class EMAState(NamedTuple):
    first_moment: torch.Tensor
    second_moment: torch.Tensor


class EMAMeanStd(MeanStd):
    """Exponential moving average of the first two (uncentered) moments."""

    def __init__(self, beta=1e-2, std_min_value=1e-6, std_max_value=1e6):
        self._beta = beta
        self._std_min = std_min_value
        self._std_max = std_max_value

    def init_state(self, size: int, device=None) -> EMAState:
        return EMAState(
            first_moment=torch.zeros((size,), device=device),
            second_moment=torch.ones((size,), device=device),
        )

    def update(self, state: EMAState, data) -> EMAState:
        data = data.to(torch.float32)
        dims = _reduce_dims(data)
        batch_m1 = collectives.mean(data, dim=dims)
        batch_m2 = collectives.mean(torch.square(data), dim=dims)
        return EMAState(
            first_moment=state.first_moment
            + self._beta * (batch_m1 - state.first_moment),
            second_moment=state.second_moment
            + self._beta * (batch_m2 - state.second_moment),
        )

    def mean_std(self, state: EMAState):
        var = state.second_moment - torch.square(state.first_moment)
        std = torch.clamp(torch.sqrt(var), self._std_min, self._std_max)
        return state.first_moment, std


def merge_means(mu1, mu2, n1, n2):
    total = n1 + n2
    return (n1 * mu1 + n2 * mu2) / total


def merge_summed_variances(v1, v2, mu1, mu2, merged_mean, n1, n2):
    return (
        v1
        + n1 * torch.square(mu1 - merged_mean)
        + v2
        + n2 * torch.square(mu2 - merged_mean)
    )


class AverageState(NamedTuple):
    observation_count: torch.Tensor  # f32[size]
    update_count: torch.Tensor  # i32[]
    mean: torch.Tensor  # f32[size]
    summed_variance: torch.Tensor  # f32[size]


class AverageMeanStd(MeanStd):
    """Welford-style running mean/std over all past samples."""

    def __init__(self, std_min_value=1e-6, std_max_value=1e6):
        self._std_min = std_min_value
        self._std_max = std_max_value

    def init_state(self, size: int, device=None) -> AverageState:
        zeros = torch.zeros((size,), device=device)
        return AverageState(
            observation_count=zeros,
            update_count=torch.zeros((), dtype=torch.int32, device=device),
            mean=zeros,
            summed_variance=zeros,
        )

    def update(self, state: AverageState, data) -> AverageState:
        data = data.to(torch.float32)
        dims = _reduce_dims(data)
        count = float(collectives.count(data, dims))
        observation_count = state.observation_count + count

        diff_to_old_mean = data - state.mean
        mean = state.mean + (
            collectives.sum(diff_to_old_mean, dim=dims) / observation_count)
        variance_update = collectives.sum(
            diff_to_old_mean * (data - mean), dim=dims)
        return AverageState(
            observation_count=observation_count,
            update_count=state.update_count + 1,
            mean=mean,
            summed_variance=state.summed_variance + variance_update,
        )

    def merge(self, state: AverageState, other: AverageState, alpha=1.0):
        """Merge ``other`` into ``state``; alpha=0 leaves ``state`` as it is
        (alpha may be a tensor, so the choice needs no host sync)."""
        new_mean = merge_means(
            state.mean, other.mean,
            state.observation_count, other.observation_count,
        )
        new_sv = merge_summed_variances(
            state.summed_variance, other.summed_variance,
            state.mean, other.mean, new_mean,
            state.observation_count, other.observation_count,
        )
        return AverageState(
            observation_count=state.observation_count
            + alpha * other.observation_count,
            update_count=state.update_count + 1,
            mean=alpha * new_mean + (1.0 - alpha) * state.mean,
            summed_variance=alpha * new_sv
            + (1.0 - alpha) * state.summed_variance,
        )

    def reset(self, state: AverageState, alpha=1.0):
        return AverageState(
            observation_count=(1.0 - alpha) * state.observation_count,
            update_count=((1.0 - alpha) * state.update_count).to(torch.int32),
            mean=(1.0 - alpha) * state.mean,
            summed_variance=(1.0 - alpha) * state.summed_variance,
        )

    def mean_std(self, state: AverageState):
        # Clamping both the variance and the count at std_min^2 makes the
        # initial std one.
        minval = self._std_min * self._std_min
        eff_var = torch.clamp(state.summed_variance, min=minval)
        eff_count = torch.clamp(state.observation_count, min=minval)
        std = torch.clamp(torch.sqrt(eff_var / eff_count), self._std_min,
                          self._std_max)
        return state.mean, std


class FixedMeanStd(MeanStd):
    def __init__(self, mean=0.0, std=1.0):
        self._mean = mean
        self._std = std
        self._size = None
        self._device = None

    def init_state(self, size: int, device=None):
        self._size = size
        self._device = device
        return ()

    def update(self, state, data):
        return state

    def mean_std(self, state):
        vec = torch.ones((self._size,), device=self._device)
        return self._mean * vec, self._std * vec


class TwoLevelState(NamedTuple):
    upper: AverageState
    buffer: AverageState


class TwoLevelAverageMeanStd(MeanStd):
    """AverageMeanStd with a periodically flushed buffer level for
    precision."""

    def __init__(self, std_min_value=1e-6, std_max_value=1e6,
                 buffer_size=1e5):
        self._std_min = std_min_value
        self._std_max = std_max_value
        self._buffer_size = int(buffer_size)
        self._inner = AverageMeanStd(0.0, float("inf"))

    def init_state(self, size: int, device=None) -> TwoLevelState:
        return TwoLevelState(
            upper=self._inner.init_state(size, device),
            buffer=self._inner.init_state(size, device),
        )

    def update(self, state: TwoLevelState, data) -> TwoLevelState:
        buffer = self._inner.update(state.buffer, data)
        flush = (buffer.update_count >= self._buffer_size).to(torch.float32)
        upper = self._inner.merge(state.upper, buffer, alpha=flush)
        buffer = self._inner.reset(buffer, alpha=flush)
        return TwoLevelState(upper=upper, buffer=buffer)

    def mean_std(self, state: TwoLevelState):
        upper, buffer = state.upper, state.buffer
        total_count = upper.observation_count + buffer.observation_count
        merged_mean = merge_means(
            upper.mean, buffer.mean,
            upper.observation_count, buffer.observation_count,
        )
        merged_sv = merge_summed_variances(
            upper.summed_variance, buffer.summed_variance,
            upper.mean, buffer.mean, merged_mean,
            upper.observation_count, buffer.observation_count,
        )
        merged_sv = torch.clamp(merged_sv, min=0.0)
        std = torch.sqrt(merged_sv / torch.clamp(total_count, min=1.0))
        empty = total_count == 0.0
        mean = torch.where(empty, torch.zeros_like(merged_mean), merged_mean)
        std = torch.where(empty, torch.ones_like(std), std)
        return mean, torch.clamp(std, self._std_min, self._std_max)
