"""KL / entropy policy regularizer with a coefficient per term.

Port of ``seed_rl_tpu/agents/ppo/policy_regularizers.py``. The terms are
``kl_pi_mu`` (KL(pi||mu)), ``kl_mu_pi`` (KL(mu||pi)), ``entropy`` (the
negative entropy enters the loss, so an entropy constraint reads
-entropy <= threshold) and ``kl_ref_pi`` (KL from the zero-parameter
reference distribution to pi). Each coefficient is fixed or a Lagrange
constraint. All four terms are computed and logged whichever are active.

For a reparametrizable distribution the entropy is a one-sample estimate:
it draws from ``generator``, or takes ``noise`` (standard normal, shaped
like the action locations) in place of the draw.
"""

from typing import Optional

import torch

from seed_rl_torch.agents.ppo import constraints

_VALID = ("kl_pi_mu", "kl_mu_pi", "entropy", "kl_ref_pi")


class KLPolicyRegularizer:
    def __init__(self, **coefficients):
        for key in coefficients:
            if key not in _VALID:
                raise ValueError(f"unknown regularizer term {key!r}")
        self.coefficients = {
            k: constraints.as_coefficient(v) for k, v in coefficients.items()
        }

    def init_params(self, device=None):
        return {k: c.init_params(device)
                for k, c in self.coefficients.items()}

    def postprocess_params_(self, params):
        for k, p in params.items():
            self.coefficients[k].postprocess_params_(p)
        return params

    def __call__(
        self,
        params,
        parametric_action_distribution,
        pi_logits,
        mu_logits,
        actions,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ):
        """Returns (per-step loss [T, B], scalar adjustment loss, logs)."""
        dist = parametric_action_distribution
        losses = {
            "kl_pi_mu": dist.kl_divergence(pi_logits, mu_logits),
            "kl_mu_pi": dist.kl_divergence(mu_logits, pi_logits),
            "kl_ref_pi": dist.kl_divergence(torch.zeros_like(pi_logits),
                                            pi_logits),
            "entropy": -(
                dist.entropy(pi_logits, generator, noise)
                if dist.reparametrizable else dist.entropy(pi_logits)),
        }
        logs = {
            f"KLPolicyRegularizer/{k}": torch.mean(
                v * (-1.0 if k == "entropy" else 1.0))
            for k, v in losses.items()
        }
        per_step_loss = torch.zeros(pi_logits.shape[:-1],
                                    device=pi_logits.device)
        global_loss = torch.zeros((), device=pi_logits.device)
        for key, coe in self.coefficients.items():
            loss = losses[key]
            logs[f"KLPolicyRegularizer/{key}/coefficient"] = coe.value(
                params[key])
            per_step_loss = per_step_loss + coe.scale_loss(params[key], loss)
            global_loss = global_loss + coe.adjustment_loss(
                params[key], torch.mean(loss))
        logs["KLPolicyRegularizer/per_step_loss"] = torch.mean(per_step_loss)
        logs["KLPolicyRegularizer/global_loss"] = global_loss
        return per_step_loss, global_loss, logs
