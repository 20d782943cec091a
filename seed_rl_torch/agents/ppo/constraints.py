"""Loss coefficients: fixed or Lagrange-adaptive.

Port of ``seed_rl_tpu/agents/ppo/constraints.py``: ``FixedCoefficient`` and
``LagrangeInequalityCoefficient`` (alpha = exp(speed * param), the soft
inequality f(x) + sg(alpha) * x + alpha * sg(threshold - x), and the clip
of the parameter to the alpha range after each optimizer step).

A coefficient's trainable parameters are a dict of tensors from
``init_params`` ({} for a fixed one); the other methods are functions of
it. ``postprocess_params_`` clips in place, as the learner does after each
optimizer step.
"""

import math
from typing import Dict

import torch


class Coefficient:
    def init_params(self, device=None) -> Dict[str, torch.Tensor]:
        return {}

    def value(self, params):
        raise NotImplementedError

    def adjustment_loss(self, params, reference_value):
        return torch.zeros((), device=reference_value.device)

    def scale_loss(self, params, unscaled_loss):
        return self.value(params).detach() * unscaled_loss

    def postprocess_params_(self, params):
        return params


class FixedCoefficient(Coefficient):
    def __init__(self, value: float):
        self._value = torch.tensor(value, dtype=torch.float32)

    def init_params(self, device=None):
        # No parameter: the value moves to the device the learner runs on.
        self._value = self._value.to(device)
        return {}

    def value(self, params):
        return self._value


class LagrangeInequalityCoefficient(Coefficient):
    """Soft inequality x <= threshold through an adaptive multiplier.

    Minimizing f(x) + sg(alpha)*x + alpha*sg(threshold - x) makes alpha
    grow while x > threshold (pushing x down) and shrink otherwise.
    """

    def __init__(self, threshold: float, init_alpha: float = 1.0,
                 alpha_range=(1e-6, 1e6), adjustment_speed: float = 1.0):
        if alpha_range[0] < 0:
            raise ValueError("alpha_range must be non-negative")
        self.threshold = threshold
        self.init_alpha = init_alpha
        self.alpha_range = alpha_range
        self.adjustment_speed = adjustment_speed

    def init_params(self, device=None):
        return {"param": torch.tensor(
            math.log(self.init_alpha) / self.adjustment_speed,
            dtype=torch.float32, device=device)}

    def value(self, params):
        return torch.exp(self.adjustment_speed * params["param"])

    def adjustment_loss(self, params, reference_value):
        return self.value(params) * (
            self.threshold - torch.mean(reference_value)).detach()

    def postprocess_params_(self, params):
        lo = math.log(self.alpha_range[0]) / self.adjustment_speed
        hi = math.log(self.alpha_range[1]) / self.adjustment_speed
        with torch.no_grad():
            params["param"].clamp_(lo, hi)
        return params


def as_coefficient(value) -> Coefficient:
    if isinstance(value, Coefficient):
        return value
    return FixedCoefficient(float(value))
