"""Advantage-based policy losses: PG / V-trace-IS / PPO / AWR / V-MPO.

Port of ``seed_rl_tpu/agents/ppo/policy_losses.py``:
- ``AdvantagePreprocessor``: normalize / top half / positive only / offset,
  returning (processed, mask);
- ``GeneralizedAdvantagePolicyLoss``: one loss covering PG (-logp * adv),
  V-trace (importance weights), PPO (the mask form of clipping, with the
  gradients of the clipped surrogate), AWR (exp-transformed advantages
  over a temperature) and V-MPO (softmax over all samples, the top half,
  a Lagrange temperature adjusted by the KL of eq. (4));
- the factories ``pg``, ``vtrace_is``, ``ppo``, ``awr``, ``bc_logp``,
  ``vmpo`` and ``repeat_positive_advantages``.

Trainable pieces (the V-MPO temperature) follow ``constraints.py``:
``init_params`` gives a dict of tensors, the rest are functions of it.
"""

import math
from typing import Callable, Optional

import torch

from seed_rl_torch.agents.ppo import constraints
from seed_rl_torch.parallel import collectives


class AdvantagePreprocessor:
    def __init__(self, normalize: bool = False, only_positive: bool = False,
                 only_top_half: bool = False,
                 offset: Optional[float] = None):
        self.normalize = normalize
        self.only_positive = only_positive
        self.only_top_half = only_top_half
        self.offset = offset

    def __call__(self, advantages):
        mask = torch.ones_like(advantages)
        if self.normalize:
            advantages = advantages - collectives.mean(advantages)
            advantages = advantages / (
                collectives.std(advantages, correction=0) + 1e-8)
        if self.only_top_half:
            # The k-th largest value; ties with it stay in the top half.
            kth = collectives.kth_largest(
                advantages, collectives.count(advantages) // 2)
            mask = mask * (advantages >= kth).to(torch.float32)
        if self.only_positive:
            mask = mask * (advantages > 0.0).to(torch.float32)
        if self.offset is not None:
            advantages = advantages + self.offset
        return mask * advantages, mask


def softmax_all_dims(t):
    return collectives.softmax_all(t)


class GeneralizedAdvantagePolicyLoss:
    """Returns (scalar loss, logs); trainable temperature via init_params."""

    def __init__(
        self,
        advantage_preprocessor: Optional[AdvantagePreprocessor] = None,
        use_importance_weights: bool = False,
        max_importance_weight: Optional[float] = None,
        ppo_epsilon: Optional[float] = None,
        max_advantage: Optional[float] = None,
        advantage_transformation: Optional[Callable] = None,
        temperature: Optional[constraints.Coefficient] = None,
    ):
        self.advantage_preprocessor = (
            advantage_preprocessor or AdvantagePreprocessor())
        self.use_importance_weights = use_importance_weights
        self.max_importance_weight = max_importance_weight
        self.ppo_epsilon = ppo_epsilon
        self.max_advantage = max_advantage
        self.advantage_transformation = advantage_transformation
        self.temperature = temperature

    def init_params(self, device=None):
        if self.temperature is None:
            return {}
        return {"temperature": self.temperature.init_params(device)}

    def postprocess_params_(self, params):
        if self.temperature is not None:
            self.temperature.postprocess_params_(params["temperature"])
        return params

    def __call__(
        self,
        params,
        advantages,
        target_action_log_probs,
        behaviour_action_log_probs,
        actions=None,
        target_logits=None,
        behaviour_logits=None,
        parametric_action_distribution=None,
    ):
        name = "GeneralizedAdvantagePolicyLoss/"
        # The logged means, reduced together at the end (one all-reduce
        # under a mesh).
        averaged = {
            name + "advantages": advantages,
            name + "abs_advantages": torch.abs(advantages),
            name + "log_pi": target_action_log_probs,
            name + "log_mu": behaviour_action_log_probs,
        }
        logs = {}
        advantages, mask = self.advantage_preprocessor(advantages)

        before_transformation = None
        if self.advantage_transformation is not None:
            temp = self.temperature.value(params["temperature"])
            logs[name + "temperature"] = temp
            advantages = advantages / temp.detach()
            if self.max_advantage is not None:
                advantages = torch.clamp(advantages, max=self.max_advantage)
            before_transformation = advantages
            advantages = mask * self.advantage_transformation(advantages)
        else:
            if self.max_advantage is not None:
                advantages = torch.clamp(advantages, max=self.max_advantage)
            advantages = advantages * mask
        averaged[name + "processed_advantages"] = advantages

        loss = -target_action_log_probs * advantages.detach()
        log_rho = (target_action_log_probs
                   - behaviour_action_log_probs).detach()
        if self.ppo_epsilon is not None:
            # The mask form of PPO clipping: where the surrogate would be
            # clipped and moving further would improve it, the gradient is
            # zero, as in the min(clip) form.
            log_bound = math.log(1.0 + self.ppo_epsilon)
            clip_pos = (advantages > 0) & (log_rho > log_bound)
            clip_neg = (advantages < 0) & (log_rho < -log_bound)
            loss_mask = (~(clip_pos | clip_neg)).to(torch.float32)
            loss = loss * loss_mask
            log_rho = log_rho * loss_mask  # no overflow in exp
            averaged[name + "p_ppo_clipped"] = loss_mask
        if self.max_importance_weight is not None:
            log_rho = torch.clamp(log_rho,
                                  max=math.log(self.max_importance_weight))
        averaged[name + "log_rho"] = log_rho
        if self.use_importance_weights:
            loss = loss * torch.exp(log_rho)
        loss = collectives.mean(loss)

        if self.advantage_transformation is not None:
            # Temperature adjustment: KL between the nonparametric target
            # distribution and the behaviour one (V-MPO eq. 4).
            adv = before_transformation * mask
            adv = adv - (1.0 - mask) * 1e3  # -> 0 after exp
            kl = collectives.logsumexp(adv) - torch.log(
                collectives.sum(mask) + 1e-3)
            logs[name + "mpo_kl"] = kl
            loss = loss + self.temperature.adjustment_loss(
                params["temperature"], kl)
        means = collectives.means(averaged)
        if name + "p_ppo_clipped" in means:
            means[name + "p_ppo_clipped"] = 1 - means[name + "p_ppo_clipped"]
        return loss, {**means, **logs}


def pg():
    return GeneralizedAdvantagePolicyLoss()


def vtrace_is(max_importance_weight=1.0):
    return GeneralizedAdvantagePolicyLoss(
        use_importance_weights=True,
        max_importance_weight=max_importance_weight,
    )


def ppo(epsilon, normalize_advantages=False, advantage_offset=None):
    return GeneralizedAdvantagePolicyLoss(
        use_importance_weights=True,
        ppo_epsilon=epsilon,
        advantage_preprocessor=AdvantagePreprocessor(
            normalize=normalize_advantages, offset=advantage_offset),
    )


def awr(beta, w_max):
    return GeneralizedAdvantagePolicyLoss(
        advantage_transformation=torch.exp,
        temperature=constraints.FixedCoefficient(beta),
        max_advantage=math.log(w_max),
    )


def bc_logp():
    return GeneralizedAdvantagePolicyLoss(
        advantage_transformation=torch.ones_like,
        temperature=constraints.FixedCoefficient(1.0),
    )


def vmpo(e_n):
    """Top-half V-MPO loss; add a KL(mu||pi) regularizer for full V-MPO."""
    return GeneralizedAdvantagePolicyLoss(
        advantage_transformation=softmax_all_dims,
        advantage_preprocessor=AdvantagePreprocessor(only_top_half=True),
        temperature=constraints.LagrangeInequalityCoefficient(
            threshold=e_n, adjustment_speed=10.0),
    )


def repeat_positive_advantages():
    """Supervised learning on positive-advantage actions (the AWR / V-MPO
    limit)."""
    return awr(beta=1e-6, w_max=1.0)
