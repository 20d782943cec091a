"""Observation normalization with a trainable compensation affine.

Port of ``seed_rl_tpu/agents/ppo/input_normalization.py``. Inputs are
normalized by tracked mean/std; the affine (a, b) applies after the
normalization (and clipping). When the statistics move from (m, s) to
(m', s'), reassigning a' = s'/s * a and b' = b + a/s * (m' - m) keeps
(x - m)/s * a + b unchanged: a statistics update never changes the policy
or the value function.
"""

from typing import Any, Dict, Tuple

import torch

from seed_rl_torch.ops.running_statistics import MeanStd


class InputNormalization:
    def __init__(self, mean_std_tracker: MeanStd, input_size: int):
        self.tracker = mean_std_tracker
        self.input_size = input_size

    def init_state(self, device=None):
        return self.tracker.init_state(self.input_size, device)

    def init_params(self, device=None) -> Dict[str, torch.Tensor]:
        return {
            "compensation_mean": torch.zeros((self.input_size,),
                                             device=device),
            "compensation_std": torch.ones((self.input_size,), device=device),
        }

    def normalize(self, state, x):
        return self.tracker.normalize(state, x)

    def correct(self, params, x):
        return params["compensation_std"] * x + params["compensation_mean"]

    def update_statistics(
        self, state, params, data
    ) -> Tuple[Any, Dict[str, torch.Tensor]]:
        mean1, std1 = self.tracker.mean_std(state)
        new_state = self.tracker.update(state, data)
        mean2, std2 = self.tracker.mean_std(new_state)
        new_params = {
            "compensation_std": std2 / std1 * params["compensation_std"],
            "compensation_mean": params["compensation_mean"]
            + params["compensation_std"] / std1 * (mean2 - mean1),
        }
        return new_state, new_params

    def mean_std(self, state):
        return self.tracker.mean_std(state)
