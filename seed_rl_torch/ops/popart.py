"""PopArt normalization of value targets, optionally with compensation.

Port of ``seed_rl_tpu/ops/popart.py``. Value targets are normalized by
tracked mean/std. With ``compensate`` a trainable affine pair (a, b)
corrects the value prediction, and whenever the statistics move from
(m, s) to (m', s') the pair is reassigned so that
s*(x*a + b) + m == s'*(x*a' + b') + m': a statistics update never changes
the implicit value prediction.

The tracker state is not trained: ``update_statistics`` returns the new
state. The compensation pair is a dict of tensors the caller trains (the
PPO learner holds it as parameters); ``update_statistics`` returns its
reassigned values and leaves the caller to write them.
"""

from typing import Any, Dict, Tuple

import torch

from seed_rl_torch.ops.running_statistics import MeanStd


class PopArt:
    def __init__(self, mean_std_tracker: MeanStd, compensate: bool = True):
        self.tracker = mean_std_tracker
        self.compensate = compensate

    def init_state(self, device=None):
        return self.tracker.init_state(1, device)

    def init_params(self, device=None) -> Dict[str, torch.Tensor]:
        if not self.compensate:
            return {}
        return {
            "compensation_mean": torch.zeros((), device=device),
            "compensation_std": torch.ones((), device=device),
        }

    def normalize_target(self, state, x):
        return self.tracker.normalize(state, x[..., None]).squeeze(-1)

    def normalize_advantage(self, state, x):
        _, std = self.tracker.mean_std(state)
        return x / std

    def correct_prediction(self, params, x):
        if not self.compensate:
            return x
        return params["compensation_std"] * x + params["compensation_mean"]

    def unnormalize_prediction(self, state, x):
        return self.tracker.unnormalize(state, x[..., None]).squeeze(-1)

    def update_statistics(
        self, state, params, data
    ) -> Tuple[Any, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Returns (new_state, new_params, logs). ``data``: f32[T, B]."""
        mean1, std1 = self.tracker.mean_std(state)
        new_state = self.tracker.update(state, data[..., None])
        mean2, std2 = self.tracker.mean_std(new_state)
        logs = {
            "PopArt/mean": mean2.squeeze(-1),
            "PopArt/std": std2.squeeze(-1),
        }
        if not self.compensate:
            return new_state, params, logs
        new_std = (std1 / std2).squeeze(-1) * params["compensation_std"]
        new_mean = ((mean1 - mean2 + std1 * params["compensation_mean"])
                    / std2).squeeze(-1)
        return (
            new_state,
            {"compensation_mean": new_mean, "compensation_std": new_std},
            logs,
        )
