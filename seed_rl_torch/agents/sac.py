"""Soft Actor-Critic (with optional HER): the fused on-device learner.

Port of ``seed_rl_tpu/agents/sac.py``:
- actor: with a reparametrizable distribution the DDPG-style pathwise
  gradient, loss ``-mean(sg(dQmin/da) * a) - alpha * mean(entropy)``;
  otherwise the normalized-advantage policy gradient;
- V regresses toward ``sg(min_Q(s, a ~ pi) - alpha * log pi(a|s))``;
- Q regresses, on the behaviour actions, toward ``r + gamma * (1 - d) *
  next_v``, where ``next_v`` is the target net's V (``bootstrap_net="v"``)
  or the target net's min-Q of a fresh action plus ``alpha * entropy``
  (``"q"``);
- alpha = exp(speed * param), adjusted toward ``target_entropy`` when set;
  the param is clipped to +-20/speed after each step;
- polyak target updates ``target <- p * target + (1 - p) * online`` every
  ``update_target_every_n_step`` batches;
- HER: rollouts store ``her_window_length``-step windows, the replay
  relabels goals and cuts training unrolls out of them, and the Q target
  bootstraps against the previous step's desired goal.

Replay is uniform (importance exponent 0). Truncation folds into ``done``
and is treated as termination, as in the JAX package.

Where the JAX package passes parameter trees, here the agent's network
holds the online parameters and a second ``SACAgent`` (a copy of the first,
gradients off) the target ones, with its own polyak-averaged copy of the
observation statistics when the agent normalizes, as the JAX package's
target tree holds one. The learner holds the entropy-cost parameter and
the optimizer; the train state carries the replay, the rollout, the
episode statistics and the step and batch counts (host ints).

``SACHostLearner`` is the split learner of the host data path
(``host_offpolicy.py``): uniform replay in host RAM, the same loss. Both
learners share the update (``SACUpdate``): the nets, the entropy cost, the
optimizer, one batch's step and the polyak move.
"""

import copy
import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.distributions import ParametricDistribution
from seed_rl_torch.ops import normalizer
from seed_rl_torch.parallel import collectives
from seed_rl_torch.parallel.mesh import Mesh
from seed_rl_torch.replay import (
    REPLAY_SHARDS,
    HERDraws,
    HindsightExperienceReplay,
    PrioritizedReplay,
    ReplayState,
)
from seed_rl_torch.rollout import (
    ROLLOUT_SHARDS,
    RolloutEngine,
    RolloutState,
    Unroll,
)
from seed_rl_torch.types import AgentOutput
from seed_rl_torch.utils import episode_stats
from seed_rl_torch.utils.checkpoint import generator_states, load_train_state


class SACAgent:
    """Rollout- and loss-facing wrapper of a SAC net.

    With ``observation_size`` set, every head sees observations normalized
    by streaming statistics of that width (``obs_norm``), folded once per
    rollout by the learner, as the JAX package's
    ``normalize_observations=True`` does.
    """

    def __init__(self, net: torch.nn.Module,
                 distribution: ParametricDistribution,
                 observation_size: Optional[int] = None):
        self.net = net
        self.distribution = distribution
        self.obs_norm = None
        if observation_size is not None:
            device = next(net.parameters()).device
            self.obs_norm = normalizer.init(observation_size, device)

    @property
    def normalize_observations(self) -> bool:
        return self.obs_norm is not None

    def _normalized(self, env_output):
        if self.obs_norm is None:
            return env_output
        return env_output._replace(
            observation=normalizer.normalize_observation(
                self.obs_norm, env_output.observation))

    def update_observation_normalization(self, observation):
        self.obs_norm = normalizer.update_from_observation(
            self.obs_norm, observation)

    def initial_state(self, batch_size: int):
        return self.net.initial_state(batch_size)

    @property
    def has_shared_embedding(self) -> bool:
        """True for nets with a shared encoder (the conv torso): the loss
        then runs it once per parameter set, not once per head call."""
        return hasattr(self.net, "get_embedding")

    def embed(self, prev_action, env_output, state):
        """The net's shared embedding, or None where it has none."""
        if not self.has_shared_embedding:
            return None
        return self.net.get_embedding(
            prev_action, self._normalized(env_output), state)

    def action_params(self, prev_action, env_output, state, embedding=None):
        if embedding is not None:
            return self.net.get_action_params_from_embedding(embedding)
        return self.net.get_action_params(
            prev_action, self._normalized(env_output), state)

    def v(self, prev_action, env_output, state, embedding=None):
        if embedding is not None:
            return self.net.get_v_from_embedding(embedding)
        return self.net.get_v(prev_action, self._normalized(env_output),
                              state)

    def q(self, prev_action, env_output, state, action, embedding=None):
        if embedding is not None:
            return self.net.get_q_from_embedding(embedding, action)
        return self.net.get_q(prev_action, self._normalized(env_output),
                              state, action)

    def policy_step(self, prev_action, env_output, core_state,
                    generator: Optional[torch.Generator] = None,
                    deterministic: bool = False, noise=None):
        """One step on ``[B]`` inputs: samples from the actor (``noise``,
        the tree of ``distribution.draws``, in place of the generator's
        draws), or with ``deterministic`` takes its distribution's mode; a
        recurrent net advances every net's carry either way."""
        if self.net.stateless:
            action_params = self.action_params(prev_action, env_output,
                                               core_state)
        else:
            action_params, core_state = self.net.step(
                prev_action, self._normalized(env_output), core_state)
        if deterministic:
            action = self.distribution.mode(action_params)
        else:
            action = self.distribution.sample(action_params, generator,
                                              noise)
        # SAC stores no baseline; the slot keeps AgentOutput's layout.
        baseline = torch.zeros(action_params.shape[:-1],
                               device=action_params.device)
        return AgentOutput(action, action_params, baseline), core_state


@dataclasses.dataclass(frozen=True)
class SACConfig:
    """Defaults = the JAX package's (reference SAC learner flags)."""

    discounting: float = 0.99
    entropy_cost: float = 0.01
    target_entropy: Optional[float] = None
    entropy_cost_adjustment_speed: float = 1.0
    max_abs_reward: float = 0.0
    bootstrap_net: str = "v"  # 'v' or 'q'
    polyak: float = 0.9
    update_target_every_n_step: int = 1
    replay_buffer_size: int = 10_000
    replay_buffer_min_size: int = 256
    batch_size: int = 256
    train_batches_per_step: int = 1
    unroll_length: int = 1  # training unroll (cut from windows under HER)
    her_window_length: Optional[int] = None
    her_substitution_probability: float = 0.8
    num_action_repeats: int = 1


class StoredUnroll(NamedTuple):
    """One replay item: the core state before the unroll, and item-major
    ``[T + 1, ...]`` timesteps."""

    agent_state: Any
    prev_actions: Any
    env_outputs: Any
    agent_actions: Any


class SACNoise(NamedTuple):
    """The loss's four draws, each in place of the generator's: the
    standard normal (tanh-normal) or Gumbel (categorical) noise of the
    sampled action and of the next action, and the standard normal noise of
    the two one-sample entropy estimates."""

    sample: Optional[torch.Tensor] = None
    entropy: Optional[torch.Tensor] = None
    next_sample: Optional[torch.Tensor] = None
    next_entropy: Optional[torch.Tensor] = None


class SACTrainState(NamedTuple):
    replay: ReplayState
    rollout: RolloutState
    stats: episode_stats.EpisodeStatsState
    step: int  # train steps (rollout cycles)
    batches: int  # optimization batches


def entropy_cost_value(config: SACConfig, param: torch.Tensor):
    return torch.exp(config.entropy_cost_adjustment_speed * param)


def compute_loss(
    config: SACConfig,
    agent: SACAgent,
    target_agent: SACAgent,
    entropy_cost_param: torch.Tensor,
    agent_state,
    prev_actions,
    env_outputs,
    agent_actions,
    generator: Optional[torch.Generator] = None,
    noise: SACNoise = SACNoise(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and metrics on time-major ``[T + 1, B]`` inputs. Under
    ``collectives.over(mesh)`` the batch statistics (means, the discrete
    actor's std) run over every rank's share of the batch."""
    mean = collectives.mean
    if config.bootstrap_net not in ("v", "q"):
        raise ValueError(f"unknown bootstrap_net {config.bootstrap_net!r}")
    dist = agent.distribution
    alpha = entropy_cost_value(config, entropy_cost_param)
    sg_alpha = alpha.detach()

    rewards = env_outputs.reward[1:]
    discounts = (~env_outputs.done[1:]).to(torch.float32) * config.discounting
    if config.max_abs_reward:
        rewards = torch.clamp(rewards, -config.max_abs_reward,
                              config.max_abs_reward)

    inputs = (prev_actions[:-1],
              pytree.tree_map(lambda t: t[:-1], env_outputs), agent_state)
    target_env_outputs = env_outputs
    if config.her_window_length:
        # Bootstrap against the same (previous step's) desired goal.
        observation = dict(env_outputs.observation)
        goal = observation["desired_goal"]
        observation["desired_goal"] = torch.cat(
            [torch.zeros_like(goal[:1]), goal[:-1]], dim=0)
        target_env_outputs = env_outputs._replace(observation=observation)
    target_inputs = (prev_actions, target_env_outputs, agent_state)

    def entropy_of(params, entropy_noise):
        if dist.reparametrizable:
            return dist.entropy(params, generator, entropy_noise)
        return dist.entropy(params)

    # Shared-encoder nets run their torso once per parameter set; the heads
    # reuse the embedding (None for nets without one).
    emb_in = agent.embed(*inputs)
    action_params = agent.action_params(*inputs, embedding=emb_in)
    action = dist.sample(action_params, generator, noise.sample)
    entropy = entropy_of(action_params, noise.entropy)
    v = agent.v(*inputs, embedding=emb_in)
    logp_action = dist.log_prob(action_params, action)
    q_action = agent.q(*inputs, action.detach(), embedding=emb_in)
    min_q = torch.min(q_action, dim=-1).values
    actor_objective = min_q - sg_alpha * logp_action

    if dist.reparametrizable:
        # The pathwise gradient d(min Q)/d(action) at the sample, through
        # the Q heads only: the action is a detached leaf, the embedding a
        # constant, and no parameter's .grad is touched.
        leaf = action.detach().requires_grad_(True)
        q_leaf = agent.q(*inputs, leaf, embedding=(
            None if emb_in is None else emb_in.detach()))
        (grad_action,) = torch.autograd.grad(
            torch.sum(torch.min(q_leaf, dim=-1).values), leaf)
        actor_loss = (-mean(grad_action * action)
                      - sg_alpha * mean(entropy))
    else:
        advantage = (actor_objective - v).detach()
        advantage = advantage - mean(advantage)
        # jnp.std: the population std.
        advantage = advantage / (collectives.std(advantage, correction=0)
                                 + 0.001)
        actor_loss = -mean(advantage * logp_action)

    target_v_now = actor_objective.detach()
    v_error = v - target_v_now
    v_loss = mean(torch.square(v_error))

    q_old_action = agent.q(*inputs, agent_actions[:-1], embedding=emb_in)
    with torch.no_grad():  # the Q target is a stop-gradient
        if config.bootstrap_net == "q":
            next_action_params = agent.action_params(
                *target_inputs, embedding=agent.embed(*target_inputs))
            next_action = dist.sample(next_action_params, generator,
                                      noise.next_sample)
            next_q = target_agent.q(
                *target_inputs, next_action,
                embedding=target_agent.embed(*target_inputs))[1:]
            next_entropy = entropy_of(next_action_params,
                                      noise.next_entropy)[1:]
            next_v = (torch.min(next_q, dim=-1).values
                      + sg_alpha * next_entropy)
        else:
            next_v = target_agent.v(
                *target_inputs,
                embedding=target_agent.embed(*target_inputs))[1:]
        target_q = rewards + discounts * next_v
    q_error = q_old_action - target_q[..., None]
    q_loss = mean(torch.square(q_error))
    mean_entropy = mean(entropy.detach())

    if config.target_entropy is not None:
        entropy_adjustment_loss = alpha * (
            mean_entropy - config.target_entropy).detach()
    else:
        entropy_adjustment_loss = 0.0 * alpha

    total_loss = actor_loss + q_loss + v_loss + entropy_adjustment_loss
    metrics = {
        "Q/value": mean(q_action.detach()),
        "Q/L2_error": torch.sqrt(mean(torch.square(q_error.detach()))),
        "V/value": mean(v.detach()),
        "V/L2_error": torch.sqrt(mean(torch.square(v_error.detach()))),
        "losses/actor": actor_loss,
        "losses/Q": q_loss,
        "losses/V": v_loss,
        "losses/total": total_loss,
        "policy/entropy": mean_entropy,
        "policy/entropy_cost": alpha,
    }
    return total_loss, {k: m.detach() for k, m in metrics.items()}


def _mean_metrics(history: List[Dict[str, torch.Tensor]]):
    return {k: torch.mean(torch.stack([m[k] for m in history]))
            for k in history[0]}


def _time_major(tree):
    """Item-major ``[B, T, ...]`` leaves -> contiguous ``[T, B, ...]``."""
    return pytree.tree_map(lambda t: t.transpose(0, 1).contiguous(), tree)


class SACUpdate:
    """The online and target agents, the entropy-cost parameter, the
    optimizer and one batch's update, shared by ``SACLearner`` and
    ``SACHostLearner``.

    Args:
      agent: a ``SACAgent`` whose network holds the online parameters.
      config: loss and schedule knobs.
      optimizer: builds the optimizer from a parameter list (one optimizer
        over the net and the entropy-cost parameter, one global-norm clip
        over both, as the JAX package's optax chain); its ``step()``
        returns the pre-clip norm.
      device: the agent's device.
      seed: seeds the generator of the loss's noise (and the replay's
        draws, for the fused learner).
    """

    def __init__(self, agent: SACAgent, config: SACConfig,
                 optimizer: Callable[[List[torch.Tensor]], Any], device,
                 seed: int):
        self.agent = agent
        self.config = config
        self.net = agent.net
        self.target_agent = copy.deepcopy(agent)
        self.target_agent.net.requires_grad_(False)
        self.device = device
        mul = config.entropy_cost_adjustment_speed
        self.entropy_cost = torch.nn.Parameter(torch.tensor(
            math.log(config.entropy_cost) / mul, dtype=torch.float32,
            device=self.device))
        self.optimizer = optimizer(self.parameters())
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def parameters(self) -> List[torch.nn.Parameter]:
        """Everything the optimizer updates: the online net and the
        entropy-cost parameter."""
        return list(self.net.parameters()) + [self.entropy_cost]

    def _nets_and_optimizer(self) -> Dict[str, Any]:
        return dict(
            params={"net": self.net.state_dict(),
                    "entropy_cost": self.entropy_cost.detach()},
            target_net_params={"net": self.target_agent.net.state_dict(),
                               "obs_norm": self.target_agent.obs_norm},
            opt_state=self.optimizer.state_dict(),
            obs_norm=self.agent.obs_norm,
        )

    def _load_nets_and_optimizer(self, tree: Dict[str, Any]):
        self.net.load_state_dict(tree["params"]["net"])
        with torch.no_grad():
            self.entropy_cost.copy_(tree["params"]["entropy_cost"])
        target = tree["target_net_params"]
        self.target_agent.net.load_state_dict(target["net"])
        self.target_agent.obs_norm = target["obs_norm"]
        self.optimizer.load_state_dict(tree["opt_state"])
        self.agent.obs_norm = tree["obs_norm"]

    @torch.no_grad()
    def _move_target(self):
        """target <- polyak * target + (1 - polyak) * online."""
        p = self.config.polyak
        targets = list(self.target_agent.net.parameters())
        torch._foreach_mul_(targets, p)
        torch._foreach_add_(targets, list(self.net.parameters()),
                            alpha=1.0 - p)
        if self.agent.normalize_observations:
            self.target_agent.obs_norm = pytree.tree_map(
                lambda t, o: p * t + (1.0 - p) * o,
                self.target_agent.obs_norm, self.agent.obs_norm)

    def optimize(self, items: StoredUnroll, noise: SACNoise = SACNoise(),
                 generator=None):
        """One optimization batch on item-major ``items``: loss (with
        ``noise`` in place of the draws from ``generator``, by default the
        learner's), clip + Adam, the alpha clip. Returns the metrics."""
        config = self.config
        prev_actions, env_outputs, agent_actions = _time_major(
            (items.prev_actions, items.env_outputs, items.agent_actions))
        loss, metrics = compute_loss(
            config, self.agent, self.target_agent, self.entropy_cost,
            items.agent_state, prev_actions, env_outputs, agent_actions,
            self.generator if generator is None else generator, noise)
        self.optimizer.zero_grad()
        loss.backward()
        metrics["grad/norm"] = self.optimizer.step()
        mul = config.entropy_cost_adjustment_speed
        with torch.no_grad():
            self.entropy_cost.clamp_(-20.0 / mul, 20.0 / mul)
        return metrics


def _unroll_to_items(unroll: Unroll) -> StoredUnroll:
    """A time-major unroll -> item-major ``[B, T + 1]`` items of every env
    (SAC has no eval envs)."""
    ts = unroll.timesteps

    def to_items(t):
        return t.transpose(0, 1)

    return StoredUnroll(
        agent_state=unroll.agent_state,
        prev_actions=pytree.tree_map(to_items, ts.prev_action),
        env_outputs=pytree.tree_map(to_items, ts.env_output),
        agent_actions=pytree.tree_map(to_items, ts.agent_output.action),
    )


class SACLearner(SACUpdate):
    """Fused on-device SAC: rollout, insert, then ``train_batches_per_step``
    x (sample, loss, clip + Adam, alpha clip, polyak).

    Args:
      engine: the rollout engine, over ``her_window_length`` steps under
        HER and ``unroll_length`` otherwise (its env's device is the
        learner's).
      agent: a ``SACAgent`` whose network holds the online parameters.
      config: loss, replay and schedule knobs.
      optimizer: builds the optimizer from a parameter list, e.g.
        ``functools.partial(optim.ClippedAdam, learning_rate=3e-4,
        clip_norm=40.0)``: one optimizer over the net and the entropy-cost
        parameter, one global-norm clip over both, as the JAX package's
        optax chain; its ``step()`` returns the pre-clip norm.
      compute_reward_fn: HER's reward of (achieved_goal, desired_goal).
      seed: seeds the generator of the replay's draws and the loss's noise.
    """

    # The train state's per-rank fields under a mesh (``parallel/dp.py``).
    SHARDED_FIELDS = {"replay": REPLAY_SHARDS, "rollout": ROLLOUT_SHARDS,
                      "stats": episode_stats.SHARDS}
    REPLICATED_FIELDS = ("step", "batches")

    def __init__(
        self,
        engine: RolloutEngine,
        agent: SACAgent,
        config: SACConfig,
        optimizer: Callable[[List[torch.Tensor]], Any],
        compute_reward_fn: Optional[Callable] = None,
        seed: int = 0,
    ):
        if engine.overlap != 0:
            raise ValueError("SAC uses the 1-step boundary overlap only")
        if config.replay_buffer_min_size > config.replay_buffer_size:
            raise ValueError("replay_buffer_min_size exceeds the buffer")
        # The mesh of this rank's share of the envs (``parallel``); an env
        # without one is the one-rank mesh's.
        self.mesh = mesh = getattr(engine.env, "mesh", None) or Mesh(
            0, 1, engine.env.device)
        if config.batch_size % mesh.size:
            raise ValueError(f"batch_size={config.batch_size} does not "
                             f"divide over {mesh.size} replicas")
        if config.her_window_length:
            if engine.unroll_length != config.her_window_length:
                raise ValueError("under HER the rollout unroll must be "
                                 "her_window_length")
            if compute_reward_fn is None:
                raise ValueError("HER needs compute_reward_fn")
            self.replay = HindsightExperienceReplay(
                config.replay_buffer_size, importance_sampling_exponent=0.0,
                compute_reward_fn=compute_reward_fn,
                unroll_length=config.unroll_length,
                substitution_probability=config.her_substitution_probability,
                mesh=mesh,
            )
        else:
            if engine.unroll_length != config.unroll_length:
                raise ValueError("the rollout unroll must be unroll_length")
            self.replay = PrioritizedReplay(
                config.replay_buffer_size, importance_sampling_exponent=0.0,
                mesh=mesh)
        super().__init__(agent, config, optimizer, engine.env.device, seed)
        self.engine = engine
        self.num_envs = engine.env.num_envs
        self.frames_per_step = (engine.unroll_length * self.num_envs
                                * mesh.size * config.num_action_repeats)

    def state_tensors(self, state: SACTrainState) -> List[torch.Tensor]:
        """The train state's tensors, the target net's and the observation
        statistics, if the agent normalizes."""
        return (pytree.tree_leaves((
            state.replay.buffer, state.replay.priorities, state.rollout,
            state.stats, self.agent.obs_norm or (),
            self.target_agent.obs_norm or ()))
            + list(self.target_agent.net.parameters()))

    def checkpoint_state(self, state: SACTrainState) -> Dict[str, Any]:
        """Everything a resumed run needs (``utils/checkpoint.py``): the
        train state's fields (the replay with its cursors, the step and
        batch counts among them), the online net and the entropy cost, the
        target agent's net and statistics, the optimizer, the observation
        statistics (None without) and every generator."""
        return dict(state._asdict(), **self._nets_and_optimizer(),
                    generators=generator_states(self))

    def load_checkpoint_state(self, state: SACTrainState,
                              tree: Dict[str, Any]) -> SACTrainState:
        """Takes back a tree of ``checkpoint_state``'s structure, whole or
        its warm-start fields only; returns the train state."""
        self._load_nets_and_optimizer(tree)
        return load_train_state(self, state, tree)

    def _example_item(self, rollout: RolloutState) -> StoredUnroll:
        """Zeros shaped like one replay item, from the primed rollout."""
        steps = self.engine.unroll_length + 1
        ts = rollout.carry_timesteps

        def per_step(t):
            return torch.zeros((steps,) + tuple(t.shape[2:]), dtype=t.dtype,
                               device=t.device)

        return StoredUnroll(
            agent_state=pytree.tree_map(lambda t: torch.zeros_like(t[0]),
                                        rollout.agent_state),
            prev_actions=pytree.tree_map(per_step, ts.prev_action),
            env_outputs=pytree.tree_map(per_step, ts.env_output),
            agent_actions=pytree.tree_map(per_step, ts.agent_output.action),
        )

    def init(self) -> SACTrainState:
        """Starts the rollout, an empty replay and the counters."""
        rollout = self.engine.init()
        return SACTrainState(
            replay=self.replay.init_state(self._example_item(rollout)),
            rollout=rollout,
            stats=episode_stats.init(self.num_envs, self.device),
            step=0,
            batches=0,
        )

    def _rollout_and_insert(self, state: SACTrainState) -> SACTrainState:
        rollout, unroll = self.engine.rollout(state.rollout)
        replay, _ = self.replay.insert(
            state.replay, _unroll_to_items(unroll),
            torch.ones((self.num_envs,), device=self.device))
        new_steps = pytree.tree_map(lambda x: x[1:],
                                    unroll.timesteps.env_output)
        stats = episode_stats.update(state.stats, new_steps)
        if self.agent.normalize_observations:
            # Fold the fresh observations, once per rollout.
            self.agent.update_observation_normalization(
                new_steps.observation)
        return state._replace(rollout=rollout, replay=replay, stats=stats)

    def warmup_step(self, state: SACTrainState) -> SACTrainState:
        """Rollout + insert only: fills the buffer to its min size."""
        return self._rollout_and_insert(state)

    def train_on_batch(
        self,
        state: SACTrainState,
        indices: Optional[torch.Tensor] = None,
        draws: HERDraws = HERDraws(),
        noise: SACNoise = SACNoise(),
    ) -> Tuple[SACTrainState, Dict[str, torch.Tensor]]:
        """One optimization batch: sample (``indices`` and, under HER,
        ``draws`` in place of the generator's), loss (with ``noise``), clip
        + Adam, the alpha clip, and a polyak move every
        ``update_target_every_n_step`` batches."""
        config = self.config
        sample_kw = dict(draws=draws) if config.her_window_length else {}
        _, _, items = self.replay.sample(
            state.replay, self.generator, config.batch_size, 0,
            indices=indices, **sample_kw)
        # Every rank holds the global batch and trains on its share, with
        # its columns of the loss's global draws (or of the injected global
        # noise).
        part = self.mesh.shard(config.batch_size)
        noise = SACNoise(*(None if n is None else n[:, part]
                           for n in noise))
        metrics = self.optimize(
            pytree.tree_map(lambda t: t[part], items), noise,
            self.mesh.draws(self.generator, config.batch_size, 1))
        batches = state.batches + 1
        if batches % config.update_target_every_n_step == 0:
            self._move_target()
        return state._replace(batches=batches), metrics

    def train_step(
        self, state: SACTrainState
    ) -> Tuple[SACTrainState, Dict[str, torch.Tensor]]:
        state = self._rollout_and_insert(state)
        history = []
        for _ in range(self.config.train_batches_per_step):
            state, metrics = self.train_on_batch(state)
            history.append(metrics)
        return state._replace(step=state.step + 1), _mean_metrics(history)

    def train_many(
        self, state: SACTrainState, num_steps: int
    ) -> Tuple[SACTrainState, Dict[str, torch.Tensor]]:
        """Run ``num_steps`` train steps; metrics averaged over them."""
        history = []
        for _ in range(num_steps):
            state, metrics = self.train_step(state)
            history.append(metrics)
        return state, _mean_metrics(history)


class SACHostTrainState(NamedTuple):
    """The host learner's train state: parameters and optimizer state live
    on the nets and the optimizer, the replay and the rollout on the
    host."""

    step: int  # optimization batches


class SACHostLearner(SACUpdate):
    """SAC over host envs (MuJoCo, gym) and a uniform host-RAM replay.

    The sample-train half for ``host_offpolicy.host_offpolicy_loop``: the
    reference SAC's shape (a 1e6-transition replay, replay ratio 4, uniform
    sampling). The loss is ``compute_loss``, as in ``SACLearner``; the
    polyak move comes every ``update_target_every_n_step`` batches.
    """

    def __init__(self, agent: SACAgent, config: SACConfig,
                 optimizer: Callable[[List[torch.Tensor]], Any],
                 num_envs: int, unroll_length: int, seed: int = 0):
        super().__init__(agent, config, optimizer,
                         next(agent.net.parameters()).device, seed)
        self.num_envs = num_envs
        self.num_training_envs = num_envs  # SAC has no dedicated eval envs
        self.unroll_length = unroll_length
        self.frames_per_cycle = (unroll_length * num_envs
                                 * config.num_action_repeats)
        self.priority_exponent = 0.0  # uniform replay
        self.batch_size = config.batch_size

    def init(self) -> SACHostTrainState:
        return SACHostTrainState(step=0)

    def state_tensors(self, state: SACHostTrainState) -> List[torch.Tensor]:
        return (pytree.tree_leaves((self.agent.obs_norm or (),
                                    self.target_agent.obs_norm or ()))
                + list(self.target_agent.net.parameters()))

    def checkpoint_state(self, state: SACHostTrainState) -> Dict[str, Any]:
        """The step, the nets, the entropy cost, the statistics, the
        optimizer and the loss's generator (the replay is saved beside the
        checkpoint, ``host_offpolicy.py``)."""
        return dict(state._asdict(), **self._nets_and_optimizer(),
                    generators=generator_states(self))

    def load_checkpoint_state(self, state: SACHostTrainState,
                              tree: Dict[str, Any]) -> SACHostTrainState:
        self._load_nets_and_optimizer(tree)
        return load_train_state(self, state, tree)

    def make_items_and_priorities(self, unroll: Unroll):
        """An unroll -> (items of every env, priorities of 1)."""
        return _unroll_to_items(unroll), torch.ones(
            (self.num_envs,), device=self.device)

    def on_unroll(self, state: SACHostTrainState, unroll: Unroll):
        """Folds the unroll's new observations into the statistics."""
        if self.agent.normalize_observations:
            self.agent.update_observation_normalization(pytree.tree_map(
                lambda x: x[1:], unroll.timesteps.env_output.observation))
        return state

    def train_on_batch(self, state: SACHostTrainState, items: StoredUnroll,
                       weights: torch.Tensor, noise: SACNoise = SACNoise()):
        """One optimization batch on host-sampled items (uniform: the
        weights are ones); returns (state, priorities of 1, metrics)."""
        del weights
        metrics = self.optimize(items, noise)
        step = state.step + 1
        if step % self.config.update_target_every_n_step == 0:
            self._move_target()
        return (state._replace(step=step),
                torch.ones((self.batch_size,), device=self.device), metrics)


def learner_loop(
    learner: SACLearner,
    total_environment_frames: int,
    logger=None,
    checkpoint=None,
    log_every_steps: int = 10,
    steps_per_call: int = 1,
) -> Tuple[SACTrainState, Dict[str, Any]]:
    """Warm up to ``replay_buffer_min_size``, then train to the budget,
    logging ``episodes/mean_return`` over the window since the last log
    line (the JAX CLI's SAC loop). Returns the final state and the metrics
    of the last call. With a ``checkpoint`` manager the loop restores on
    start (a restored replay that holds the minimum is not warmed up
    again), offers a save after every call and forces one at the end."""
    state = learner.init()
    if checkpoint is not None:
        state = checkpoint.restore_or(learner, state)
    while state.replay.num_inserted < learner.config.replay_buffer_min_size:
        state = learner.warmup_step(state)
    metrics: Dict[str, Any] = {}
    frames_per_step = learner.frames_per_step
    while state.step * frames_per_step < total_environment_frames:
        state, metrics = learner.train_many(state, steps_per_call)
        step = state.step
        if logger is not None and step % log_every_steps < steps_per_call:
            metrics = dict(metrics)
            n, sum_return, _ = episode_stats.window(state.stats,
                                                    learner.mesh)
            if n > 0:
                metrics["episodes/mean_return"] = sum_return / n
                state = state._replace(
                    stats=episode_stats.reset_window(state.stats))
            logger.log(step, metrics, frames=step * frames_per_step)
        if checkpoint is not None:
            checkpoint.maybe_save(step, learner, state)
    if checkpoint is not None:
        checkpoint.maybe_save(state.step, learner, state, force=True)
    return state, metrics
