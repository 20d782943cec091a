"""Generalized on-policy loss: advantage estimator x policy loss x
regularizer x PopArt normalization of the value targets.

Port of ``seed_rl_tpu/agents/ppo/generalized_onpolicy_loss.py``:
- ``compute_advantages``: rewards clipped, then scaled; ``done`` split into
  terminated and abandoned; the discount raised to ``frame_skip``; with
  PopArt the value prediction corrected and then unnormalized for the
  bootstrap, the targets and advantages normalized afterwards and the
  statistics updated.
- ``__call__``: the policy loss on the normalized advantages; the value
  loss, MSE or Huber, with the optional PPO-style clip against the
  behaviour baseline; the regularizer per step plus its adjustment loss.
  The last timestep of an unroll serves only for bootstrapping.

The network's parameters live in the agent's module. The loss-owned
trainable parameters (PopArt compensation, Lagrange coefficients, the
V-MPO temperature) are a nested dict of tensors from ``init_params``; the
PopArt tracker state comes from ``init_norm_state`` and is never trained.
A call returns ``(loss, LossAux)``: the logs, the new tracker state and
the loss-owned parameters with the PopArt compensation reassigned, which
the learner writes after the backward pass.
"""

from typing import Any, NamedTuple, Optional

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.ops.popart import PopArt


class LossAux(NamedTuple):
    logs: dict
    norm_state: Any
    loss_params: Any


def _huber(x, delta):
    abs_x = torch.abs(x)
    return torch.where(abs_x <= delta, 0.5 * torch.square(x),
                       delta * (abs_x - 0.5 * delta))


class GeneralizedOnPolicyLoss:
    def __init__(
        self,
        agent,
        reward_normalizer: Optional[PopArt],
        parametric_action_distribution,
        advantage_estimator,
        policy_loss,
        discount_factor: float,
        regularizer=None,
        max_abs_reward: Optional[float] = None,
        handle_abandoned_episodes_properly: bool = True,
        huber_delta: Optional[float] = None,
        value_ppo_style_clip_eps: Optional[float] = None,
        baseline_cost: float = 1.0,
        include_regularization_in_returns: bool = False,
        frame_skip: int = 1,
        reward_scaling: float = 1.0,
    ):
        self.agent = agent
        self.reward_normalizer = reward_normalizer
        self.dist = parametric_action_distribution
        self.advantage_estimator = advantage_estimator
        self.policy_loss = policy_loss
        self.regularizer = regularizer
        self.max_abs_reward = max_abs_reward
        self.reward_scaling = reward_scaling
        self.baseline_cost = baseline_cost
        self.discount_factor = discount_factor
        self.frame_skip = frame_skip
        self.handle_abandoned = handle_abandoned_episodes_properly
        self.value_clip_eps = value_ppo_style_clip_eps
        self.include_regularization_in_returns = (
            include_regularization_in_returns)
        self.huber_delta = huber_delta

    def init_params(self, device=None):
        params = {"policy_loss": self.policy_loss.init_params(device)}
        if self.regularizer is not None:
            params["regularizer"] = self.regularizer.init_params(device)
        if self.reward_normalizer is not None:
            params["popart"] = self.reward_normalizer.init_params(device)
        return params

    def init_norm_state(self, device=None):
        if self.reward_normalizer is None:
            return ()
        return self.reward_normalizer.init_state(device)

    def postprocess_params_(self, params):
        """Clips the Lagrange multipliers in place, after an optimizer
        step."""
        self.policy_loss.postprocess_params_(params["policy_loss"])
        if self.regularizer is not None:
            self.regularizer.postprocess_params_(params["regularizer"])
        return params

    def _log_probs(self, learner_logits, agent_outputs):
        target = self.dist.log_prob(learner_logits, agent_outputs.action)
        behaviour = self.dist.log_prob(agent_outputs.policy_logits,
                                       agent_outputs.action)
        return target, behaviour

    def _regularizer(self, loss_params, learner_logits, agent_outputs,
                     generator, noise):
        return self.regularizer(
            loss_params["regularizer"], self.dist, learner_logits,
            agent_outputs.policy_logits, agent_outputs.action,
            generator=generator, noise=noise)

    def compute_advantages(
        self,
        loss_params,
        norm_state,
        agent_state,
        prev_actions,
        env_outputs,
        agent_outputs,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        update_stats: bool = True,
        return_learner_outputs: bool = False,
    ):
        """Returns (targets, advantages[, learner_outputs], new_norm_state,
        new_loss_params, logs); inputs are [T+1, B] time-major. Targets and
        advantages are outside the autograd graph."""
        rewards = env_outputs.reward[1:]
        done = env_outputs.done[1:]
        abandoned = env_outputs.abandoned[1:]
        if self.max_abs_reward is not None:
            rewards = torch.clamp(rewards, -self.max_abs_reward,
                                  self.max_abs_reward)
        rewards = rewards * self.reward_scaling

        (learner_logits, learner_v), _ = self.agent.unroll(
            prev_actions, env_outputs, agent_state)
        agent_outputs_c = pytree.tree_map(lambda t: t[:-1], agent_outputs)
        learner_logits_c = learner_logits[:-1]
        target_logp, behaviour_logp = self._log_probs(
            learner_logits_c.detach(), agent_outputs_c)

        with torch.no_grad():
            if self.reward_normalizer is not None:
                corrected = self.reward_normalizer.correct_prediction(
                    loss_params["popart"], learner_v)
                unnormalized = self.reward_normalizer.unnormalize_prediction(
                    norm_state, corrected)
            else:
                unnormalized = learner_v
            if not self.handle_abandoned:
                abandoned = torch.zeros_like(abandoned)
            done_terminated = done & ~abandoned
            done_abandoned = done & abandoned
            if self.include_regularization_in_returns and self.regularizer:
                additional_rewards, _, _ = self._regularizer(
                    loss_params, learner_logits_c, agent_outputs_c,
                    generator, noise)
                rewards = rewards + additional_rewards

            vs, advantages = self.advantage_estimator(
                unnormalized, rewards, done_terminated, done_abandoned,
                self.discount_factor ** self.frame_skip, target_logp,
                behaviour_logp)
            targets = vs
            if self.reward_normalizer is not None:
                targets = self.reward_normalizer.normalize_target(
                    norm_state, vs)
                advantages = self.reward_normalizer.normalize_advantage(
                    norm_state, advantages)

        logs = {}
        new_loss_params = loss_params
        if self.reward_normalizer is not None and update_stats:
            # The reassigned compensation is a function of the old one, and
            # the rest of the loss differentiates through it.
            norm_state, new_popart, pop_logs = (
                self.reward_normalizer.update_statistics(
                    norm_state, loss_params["popart"], vs))
            new_loss_params = dict(loss_params, popart=new_popart)
            logs.update({k: v.detach() for k, v in pop_logs.items()})

        out = (targets, advantages)
        if return_learner_outputs:
            out += ((learner_logits, learner_v),)
        return out + (norm_state, new_loss_params, logs)

    def __call__(
        self,
        loss_params,
        norm_state,
        agent_state,
        prev_actions,
        env_outputs,
        agent_outputs,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        normalized_targets=None,
        normalized_advantages=None,
    ):
        """Returns (total loss, LossAux). ``noise`` replaces the
        regularizer's draw for a reparametrizable distribution's entropy."""
        logs = {}
        if normalized_targets is None:
            (normalized_targets, normalized_advantages,
             (learner_logits_full, learner_v_full), norm_state, loss_params,
             adv_logs) = self.compute_advantages(
                loss_params, norm_state, agent_state, prev_actions,
                env_outputs, agent_outputs, generator=generator, noise=noise,
                update_stats=True, return_learner_outputs=True)
            logs.update(adv_logs)
            # The last timestep was only for bootstrapping.
            prev_actions, env_outputs, agent_outputs = pytree.tree_map(
                lambda t: t[:-1], (prev_actions, env_outputs, agent_outputs))
            learner_logits = learner_logits_full[:-1]
            learner_v = learner_v_full[:-1]
        else:
            (learner_logits, learner_v), _ = self.agent.unroll(
                prev_actions, env_outputs, agent_state)

        target_logp, behaviour_logp = self._log_probs(learner_logits,
                                                      agent_outputs)
        if self.reward_normalizer is not None:
            corrected = self.reward_normalizer.correct_prediction(
                loss_params["popart"], learner_v)
            old_corrected = self.reward_normalizer.correct_prediction(
                loss_params["popart"], agent_outputs.baseline)
        else:
            corrected = learner_v
            old_corrected = agent_outputs.baseline

        policy_loss, pl_logs = self.policy_loss(
            loss_params["policy_loss"], normalized_advantages, target_logp,
            behaviour_logp, actions=agent_outputs.action,
            target_logits=learner_logits,
            behaviour_logits=agent_outputs.policy_logits,
            parametric_action_distribution=self.dist)
        logs.update(pl_logs)

        v_error = normalized_targets - corrected
        logs["GeneralizedOnPolicyLoss/V_error"] = torch.mean(v_error)
        logs["GeneralizedOnPolicyLoss/abs_V_error"] = torch.mean(
            torch.abs(v_error))
        if self.huber_delta is not None:
            v_loss = _huber(v_error, self.huber_delta)
        else:
            v_loss = torch.square(v_error)
        if self.value_clip_eps is not None:
            clipped_pred = torch.clamp(
                corrected, old_corrected - self.value_clip_eps,
                old_corrected + self.value_clip_eps)
            clipped_err = normalized_targets - clipped_pred
            clipped_v_loss = (
                _huber(clipped_err, self.huber_delta)
                if self.huber_delta is not None
                else torch.square(clipped_err))
            v_loss = torch.maximum(v_loss, clipped_v_loss)
        v_loss = torch.mean(v_loss)
        logs["GeneralizedOnPolicyLoss/v_loss"] = v_loss

        if self.regularizer is not None:
            per_step_reg, reg_loss, reg_logs = self._regularizer(
                loss_params, learner_logits, agent_outputs, generator, noise)
            if not self.include_regularization_in_returns:
                reg_loss = reg_loss + torch.mean(per_step_reg)
            logs.update(reg_logs)
        else:
            reg_loss = 0.0

        total_loss = policy_loss + self.baseline_cost * v_loss + reg_loss
        logs["GeneralizedOnPolicyLoss/policy_loss"] = policy_loss
        logs["GeneralizedOnPolicyLoss/total_loss"] = total_loss
        return total_loss, LossAux(logs=logs, norm_state=norm_state,
                                   loss_params=loss_params)
