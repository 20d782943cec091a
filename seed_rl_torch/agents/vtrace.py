"""V-trace (IMPALA) agent: on-device rollout, loss and update.

Port of ``seed_rl_tpu/agents/vtrace.py``. The loss is the same: policy
gradient on V-trace advantages, 0.5-weighted baseline MSE, entropy bonus
with an optionally auto-tuned Lagrange entropy cost (cost = exp(speed *
param), param clipped to +-20/speed after each update), and a
KL(behaviour||target) penalty. The V-trace targets come from the
hand-written CUDA kernel on the card (``ops/cuda/vtrace_kernel.py``) and
from its plain version on the CPU.

Where the JAX package keeps parameters and optimizer state in a functional
train state, here the network module and the learner hold them; the train
state carries the rollout, the episode statistics and the step count. With
a ``NormalizingObservationsAgent`` the update folds the unroll's
observations into the agent's statistics after the optimizer step.
Truncation folds into ``done`` and is treated as termination, as in the
JAX package.
"""

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.agent import PolicyAgent
from seed_rl_torch.distributions import ParametricDistribution
from seed_rl_torch.ops.cuda import vtrace_kernel as vtrace_ops
from seed_rl_torch.parallel import collectives
from seed_rl_torch.parallel.mesh import Mesh
from seed_rl_torch.rollout import (
    ROLLOUT_SHARDS,
    RolloutEngine,
    RolloutState,
    Unroll,
)
from seed_rl_torch.utils import episode_stats
from seed_rl_torch.utils.checkpoint import generator_states, load_train_state


@dataclasses.dataclass(frozen=True)
class VTraceConfig:
    """Loss & schedule knobs (defaults = reference flag defaults)."""

    discounting: float = 0.99
    lambda_: float = 1.0
    entropy_cost: float = 0.00025
    target_entropy: Optional[float] = None
    entropy_cost_adjustment_speed: float = 10.0
    baseline_cost: float = 0.5
    kl_cost: float = 0.0
    max_abs_reward: float = 0.0
    num_action_repeats: int = 1


class VTraceTrainState(NamedTuple):
    rollout: RolloutState
    stats: episode_stats.EpisodeStatsState
    step: int  # training iterations


def entropy_cost_value(config: VTraceConfig, param: torch.Tensor):
    return torch.exp(config.entropy_cost_adjustment_speed * param)


def vtrace_inputs(
    config: VTraceConfig,
    agent: PolicyAgent,
    dist: ParametricDistribution,
    unroll: Unroll,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The V-trace inputs of an unroll, and the learner's policy params.

    The last timestep is bootstrap-only.
    """
    ts = unroll.timesteps
    (policy_params, baseline), _ = agent.unroll(
        ts.prev_action, ts.env_output, unroll.agent_state
    )
    behaviour_logits = ts.agent_output.policy_logits[:-1]
    actions = ts.agent_output.action[:-1]
    rewards = ts.env_output.reward[1:]
    done = ts.env_output.done[1:]
    learner_logits = policy_params[:-1]

    if config.max_abs_reward:
        rewards = torch.clamp(
            rewards, -config.max_abs_reward, config.max_abs_reward
        )
    discounts = (~done).to(torch.float32) * config.discounting
    inputs = dict(
        target_action_log_probs=dist.log_prob(learner_logits, actions),
        behaviour_action_log_probs=dist.log_prob(behaviour_logits, actions),
        discounts=discounts,
        rewards=rewards,
        values=baseline[:-1],
        bootstrap_value=baseline[-1],
    )
    return inputs, learner_logits


def compute_loss(
    config: VTraceConfig,
    agent: PolicyAgent,
    dist: ParametricDistribution,
    entropy_cost_param: torch.Tensor,
    unroll: Unroll,
    generator: Optional[torch.Generator] = None,
    entropy_noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and metrics of one unroll.

    ``entropy_noise`` (standard normal, shaped like the action locations)
    replaces the generator's draw in the sample-based entropy estimate.
    """
    inputs, learner_logits = vtrace_inputs(config, agent, dist, unroll)
    target_logp = inputs["target_action_log_probs"]
    behaviour_logp = inputs["behaviour_action_log_probs"]
    values = inputs["values"]

    # Both returns are outside the autograd graph (stop-gradient targets).
    returns = vtrace_ops.from_importance_weights(
        **inputs, lambda_=config.lambda_
    )

    # Means over the batch: over every rank's share under a mesh.
    mean = collectives.mean
    policy_loss = -mean(target_logp * returns.pg_advantages)
    v_error = returns.vs - values
    v_loss = config.baseline_cost * 0.5 * mean(torch.square(v_error))

    entropy = mean(
        dist.entropy(learner_logits, generator, entropy_noise)
        if dist.reparametrizable
        else dist.entropy(learner_logits)
    )
    entropy_cost = entropy_cost_value(config, entropy_cost_param)
    entropy_loss = entropy_cost.detach() * -entropy

    kl = behaviour_logp - target_logp
    kl_mean = mean(kl)
    kl_loss = config.kl_cost * kl_mean

    if config.target_entropy is not None:
        entropy_adjustment_loss = entropy_cost * (
            entropy - config.target_entropy
        ).detach()
    else:
        entropy_adjustment_loss = 0.0 * entropy_cost

    total_loss = (
        policy_loss + v_loss + entropy_loss + kl_loss + entropy_adjustment_loss
    )
    metrics = {
        "V/value_function": mean(values.detach()),
        "V/L2_error": torch.sqrt(mean(torch.square(v_error.detach()))),
        "losses/policy": policy_loss,
        "losses/V": v_loss,
        "losses/entropy": entropy_loss,
        "losses/kl": kl_loss,
        "losses/total": total_loss,
        "policy/entropy": entropy,
        "policy/entropy_cost": entropy_cost,
        "policy/kl(old|new)": kl_mean,
    }
    return total_loss, {k: v.detach() for k, v in metrics.items()}


class VTraceLearner:
    """On-policy IMPALA learner: rollout, loss, clip + Adam, per step.

    Args:
      engine: the rollout engine (its env's device is the learner's).
      agent: a ``PolicyAgent`` whose network holds the parameters.
      config: loss knobs.
      optimizer: builds the optimizer from a parameter list, e.g.
        ``functools.partial(optim.ClippedAdam, learning_rate=3e-4)``.
      seed: seeds the generator of the sample-based entropy estimate.
    """

    # The train state's per-rank fields under a mesh (``parallel/dp.py``).
    SHARDED_FIELDS = {"rollout": ROLLOUT_SHARDS,
                      "stats": episode_stats.SHARDS}
    REPLICATED_FIELDS = ("step",)

    def __init__(
        self,
        engine: RolloutEngine,
        agent: PolicyAgent,
        config: VTraceConfig,
        optimizer: Callable[[List[torch.Tensor]], Any],
        seed: int = 0,
    ):
        if engine.overlap != 0:
            raise ValueError("V-trace uses the 1-step boundary overlap only")
        self.engine = engine
        self.agent = agent
        self.config = config
        self.device = engine.device
        mul = config.entropy_cost_adjustment_speed
        self.entropy_cost = torch.nn.Parameter(
            torch.tensor(
                math.log(config.entropy_cost) / mul,
                dtype=torch.float32,
                device=self.device,
            )
        )
        self.optimizer = optimizer(self.parameters())
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # The mesh of this rank's share of the envs (``parallel``); a host
        # env's is the one-rank mesh.
        self.mesh = getattr(engine.env, "mesh", None) or Mesh(
            0, 1, self.device)
        self.frames_per_step = (
            engine.unroll_length * engine.env.num_envs * self.mesh.size
            * config.num_action_repeats
        )

    def parameters(self) -> List[torch.nn.Parameter]:
        """Everything the optimizer updates: the network and entropy cost."""
        return list(self.agent.net.parameters()) + [self.entropy_cost]

    def state_tensors(self, state: VTraceTrainState) -> List[torch.Tensor]:
        """The train state's tensors and the agent's observation
        statistics, if it normalizes."""
        return pytree.tree_leaves((state.rollout or (), state.stats,
                                   getattr(self.agent, "obs_norm", ())))

    def checkpoint_state(self, state: VTraceTrainState) -> Dict[str, Any]:
        """Everything a resumed run needs (``utils/checkpoint.py``): the
        train state's fields, the net and the entropy cost, the optimizer,
        the observation statistics (None without) and every generator."""
        return dict(
            state._asdict(),
            params={"net": self.agent.net.state_dict(),
                    "entropy_cost": self.entropy_cost.detach()},
            opt_state=self.optimizer.state_dict(),
            obs_norm=getattr(self.agent, "obs_norm", None),
            generators=generator_states(self),
        )

    def load_checkpoint_state(self, state: VTraceTrainState,
                              tree: Dict[str, Any]) -> VTraceTrainState:
        """Takes back a tree of ``checkpoint_state``'s structure, whole or
        its warm-start fields only; returns the train state."""
        self.agent.net.load_state_dict(tree["params"]["net"])
        with torch.no_grad():
            self.entropy_cost.copy_(tree["params"]["entropy_cost"])
        self.optimizer.load_state_dict(tree["opt_state"])
        if tree["obs_norm"] is not None:
            self.agent.obs_norm = tree["obs_norm"]
        return load_train_state(self, state, tree)

    def init(self) -> VTraceTrainState:
        """Starts the rollout and the counters (parameters live on the
        network, optimizer state on the optimizer). A host engine's
        rollout state stays outside the train state (``host_loop.py``)."""
        return VTraceTrainState(
            rollout=None if self.engine.is_host else self.engine.init(),
            stats=episode_stats.init(self.engine.env.num_envs, self.device),
            step=0,
        )

    def update(
        self,
        state: VTraceTrainState,
        unroll: Unroll,
        entropy_noise: Optional[torch.Tensor] = None,
    ) -> Tuple[VTraceTrainState, Dict[str, torch.Tensor]]:
        """One optimization step on a collected unroll (``entropy_noise``:
        the global ``[T, B, ...]`` noise in place of the draw)."""
        self.optimizer.zero_grad()
        # The entropy noise is this rank's env columns of the global draw
        # (or of the injected global noise).
        total = unroll.timesteps.prev_action.shape[1] * self.mesh.size
        generator = self.mesh.draws(self.generator, total, 1)
        if entropy_noise is not None:
            entropy_noise = entropy_noise[:, self.mesh.shard(total)]
        loss, metrics = compute_loss(
            self.config, self.agent, self.agent.distribution,
            self.entropy_cost, unroll, generator, entropy_noise,
        )
        loss.backward()
        self.optimizer.step()
        # Clip the entropy-cost param to +-20/speed so its gradient can't
        # underflow (reference learner.py:228-231).
        mul = self.config.entropy_cost_adjustment_speed
        with torch.no_grad():
            self.entropy_cost.clamp_(-20.0 / mul, 20.0 / mul)
        # Observation-normalization statistics fold, once per training step.
        if hasattr(self.agent, "update_observation_normalization"):
            self.agent.update_observation_normalization(
                unroll.timesteps.env_output.observation)

        # Episode accounting on the T new timesteps (skip the shared boundary
        # step, which the previous unroll already counted).
        new_env_outputs = pytree.tree_map(
            lambda x: x[1:], unroll.timesteps.env_output
        )
        stats = episode_stats.update(state.stats, new_env_outputs)
        return state._replace(stats=stats, step=state.step + 1), metrics

    def train_step(
        self, state: VTraceTrainState
    ) -> Tuple[VTraceTrainState, Dict[str, torch.Tensor]]:
        rollout_state, unroll = self.engine.rollout(state.rollout)
        return self.update(state._replace(rollout=rollout_state), unroll)

    def train_many(
        self, state: VTraceTrainState, num_steps: int
    ) -> Tuple[VTraceTrainState, Dict[str, torch.Tensor]]:
        """Run ``num_steps`` train steps; metrics averaged over them."""
        history = []
        for _ in range(num_steps):
            state, metrics = self.train_step(state)
            history.append(metrics)
        return state, {
            k: torch.mean(torch.stack([m[k] for m in history]))
            for k in history[0]
        }


def learner_loop(
    learner: VTraceLearner,
    total_environment_frames: int,
    logger=None,
    checkpoint=None,
    log_every_steps: int = 10,
    steps_per_call: int = 1,
) -> Tuple[VTraceTrainState, Dict[str, Any]]:
    """Train until the frame budget, logging windowed episode stats.

    Returns the final state and the metrics of the last call. The
    episode-stat window resets only when a log line fires (see the JAX
    package's ``learner_loop`` for the cadence note). With a
    ``checkpoint`` manager the loop restores on start, offers a save after
    every call and forces one at the end.
    """
    if log_every_steps < steps_per_call:
        raise ValueError(
            "log_every_steps < steps_per_call would skip log lines entirely"
        )
    state = learner.init()
    if checkpoint is not None:
        state = checkpoint.restore_or(learner, state)
    metrics: Dict[str, Any] = {}
    frames_per_step = learner.frames_per_step
    while state.step * frames_per_step < total_environment_frames:
        state, metrics = learner.train_many(state, steps_per_call)
        step = state.step
        if logger is not None and step % log_every_steps < steps_per_call:
            stats = state.stats
            n, sum_return, sum_length = episode_stats.window(
                stats, learner.mesh)
            if n > 0:
                metrics = dict(metrics)
                metrics["episodes/mean_return"] = sum_return / n
                metrics["episodes/mean_length"] = sum_length / n
                state = state._replace(
                    stats=episode_stats.reset_window(stats)
                )
            logger.log(step, metrics, frames=step * frames_per_step)
        if checkpoint is not None:
            checkpoint.maybe_save(step, learner, state)
    if checkpoint is not None:
        checkpoint.maybe_save(state.step, learner, state, force=True)
    return state, metrics
