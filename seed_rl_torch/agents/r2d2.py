"""R2D2: recurrent replay distributed DQN, on the device.

Port of ``seed_rl_tpu/agents/r2d2.py`` (the fused on-device learner):
- per-env epsilon ladder ``0.4^linspace(1, 8, num_training_envs)`` for
  training envs and a fixed eval epsilon for dedicated eval envs (ids >=
  ``num_training_envs``), whose experience is never stored;
- burn-in: the stored unroll carries ``burn_in`` overlap steps; the loss
  re-runs that prefix through both networks to warm their recurrent state,
  without gradients;
- sequence double-DQN loss on h-rescaled values with n-step Bellman (or
  Retrace) targets, priorities eta*max|TD| + (1-eta)*mean|TD|; the n-step
  targets come from the hand-written CUDA kernel on the card
  (``ops/cuda/nstep_kernel.py``) and from its plain version on the CPU;
- initial priorities from the behaviour network's own Q values at insert;
- prioritized replay with importance-sampling weights, priorities written
  back after every optimization batch;
- a hard target-network copy every ``update_target_every_n_step`` steps.

One train step: rollout, epsilon-greedy, insert, then
``train_batches_per_step`` x (sample, burn-in loss, clip + Adam, priority
write-back). A warmup phase fills the buffer to ``replay_buffer_min_size``
first.

Where the JAX package keeps parameters, target parameters and optimizer
state in a functional train state, here the online network is the agent's
module, the target network a second module of the same type, and the
optimizer holds its state; the train state carries the replay, the
rollout, both episode-stat windows and the step count (a host int, so the
target sync needs no device sync).

``R2D2HostLearner`` is the split learner of the host data path
(``host_offpolicy.py``): the replay lives in host RAM
(``replay_host.HostReplayBuffer``), and the loop turns each unroll into
items and initial priorities, and trains on batches it samples, through
the learner. Both learners share the update (``R2D2Update``): the nets,
the optimizer, and one batch's burn-in loss, clip and Adam step.
"""

import copy
import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.ops import value_ops
from seed_rl_torch.ops.cuda import nstep_kernel
from seed_rl_torch.parallel import collectives, draws
from seed_rl_torch.replay import (
    REPLAY_SHARDS,
    PrioritizedReplay,
    ReplayState,
)
from seed_rl_torch.rollout import (
    ROLLOUT_SHARDS,
    RolloutEngine,
    RolloutState,
    Unroll,
)
from seed_rl_torch.types import QAgentOutput
from seed_rl_torch.utils import episode_stats
from seed_rl_torch.utils.checkpoint import generator_states, load_train_state


def training_env_epsilons(num_training_envs: int, device=None) -> torch.Tensor:
    """eps_i = 0.4 ** linspace(1, 8, n)."""
    return 0.4 ** torch.linspace(1.0, 8.0, num_training_envs, device=device)


class R2D2Agent:
    """Epsilon-greedy wrapper around a Q-network (``VectorDuelingDQNNet``)."""

    def __init__(self, net: torch.nn.Module, epsilons: torch.Tensor):
        """``epsilons``: f32[num_envs] per-env exploration rates."""
        self.net = net
        self.epsilons = epsilons
        self.num_actions = net.num_actions

    def initial_state(self, batch_size: int):
        return self.net.initial_state(batch_size)

    def policy_step(
        self,
        prev_action,
        env_output,
        core_state,
        generator: Optional[torch.Generator] = None,
        random_actions: Optional[torch.Tensor] = None,
        uniform: Optional[torch.Tensor] = None,
        deterministic: bool = False,
        env_ids: Optional[torch.Tensor] = None,
    ) -> Tuple[QAgentOutput, Any]:
        """One epsilon-greedy step on [B] inputs, or with ``deterministic``
        the greedy one, which draws nothing.

        Row i takes the epsilon of env ``env_ids[i]`` (int[B] global env
        ids), or of env i without them: in a rollout the batch position is
        the env id, while a remote inference batch is any subset of the
        envs (the reference gathers by id the same way,
        agents/r2d2/learner.py:757-763). ``random_actions`` (int[B]) and
        ``uniform`` (f32[B] in [0, 1)) replace the generator's draws.
        """
        output, new_state = self.net(prev_action, env_output, core_state)
        if deterministic:
            return QAgentOutput(output.action, output.q_values), new_state
        batch = output.action.shape[0]
        device = output.action.device
        if random_actions is None:
            random_actions = draws.randint(
                0, self.num_actions, (batch,), generator, device=device,
                dtype=torch.int32)
        if uniform is None:
            uniform = draws.rand((batch,), generator, device=device)
        epsilons = (self.epsilons if env_ids is None
                    else self.epsilons[env_ids])
        take_random = uniform < epsilons
        action = torch.where(
            take_random, random_actions.to(torch.int32), output.action
        )
        return QAgentOutput(action, output.q_values), new_state

    def unroll(self, prev_actions, env_outputs, core_state):
        return self.net.unroll(prev_actions, env_outputs, core_state)


@dataclasses.dataclass(frozen=True)
class R2D2Config:
    """Defaults = the JAX package's (reference R2D2 learner flags)."""

    discounting: float = 0.997
    n_steps: int = 5
    burn_in: int = 40
    importance_sampling_exponent: float = 0.6
    priority_exponent: float = 0.9
    replay_buffer_size: int = 10_000  # unrolls
    replay_buffer_min_size: int = 500  # unrolls before training starts
    batch_size: int = 64
    train_batches_per_step: int = 1
    update_target_every_n_step: int = 2500
    eval_epsilon: float = 1e-3
    num_eval_envs: int = 0
    value_function_rescaling_epsilon: float = 1e-3
    num_action_repeats: int = 1
    # "nstep" or "retrace" (Retrace(lambda) clipped-trace targets).
    target: str = "nstep"
    retrace_lambda: float = 0.95


class StoredUnroll(NamedTuple):
    """One replay item, item-major (leaves [T_total, ...] per slot)."""

    agent_state: Any  # core state at the unroll's first timestep
    prev_actions: Any
    env_outputs: Any
    agent_outputs: Any


class R2D2TrainState(NamedTuple):
    replay: ReplayState
    rollout: RolloutState
    stats: episode_stats.EpisodeStatsState
    eval_stats: episode_stats.EpisodeStatsState
    step: int  # train steps (rollout cycles)


def unroll_to_items(unroll: Unroll, num_training_envs: int) -> StoredUnroll:
    """Time-major [T, B] unroll -> item-major [num_training_envs, T] views.

    Eval envs (ids >= num_training_envs) are left out: their experience is
    never stored.
    """
    n = num_training_envs
    ts = unroll.timesteps

    def to_items(t):
        return t[:, :n].transpose(0, 1)

    return StoredUnroll(
        agent_state=pytree.tree_map(lambda t: t[:n], unroll.agent_state),
        prev_actions=pytree.tree_map(to_items, ts.prev_action),
        env_outputs=pytree.tree_map(to_items, ts.env_output),
        agent_outputs=pytree.tree_map(to_items, ts.agent_output),
    )


def _time_major(tree):
    """Item-major [B, T, ...] leaves -> contiguous time-major [T, B, ...]."""
    return pytree.tree_map(lambda t: t.transpose(0, 1).contiguous(), tree)


def initial_priorities(config: R2D2Config, items: StoredUnroll):
    """Behaviour-network-only priorities of freshly inserted items: the
    online and target Q are both the stored behaviour Q, and the argmax and
    replayed action both the played action."""
    env_outputs, agent_outputs = pytree.tree_map(
        lambda t: t[config.burn_in:],
        _time_major((
            (items.env_outputs.reward, items.env_outputs.done),
            (items.agent_outputs.action, items.agent_outputs.q_values),
        )),
    )
    rewards, done = env_outputs
    action, q_values = agent_outputs
    if config.target == "retrace":
        # Insertion priorities use the error metric the training loss
        # updates them with.
        _, priorities = value_ops.retrace_loss_and_priorities(
            q_values, q_values, action, action, rewards, done,
            gamma=config.discounting,
            lambda_=config.retrace_lambda,
            rescaling_eps=config.value_function_rescaling_epsilon,
        )
        return priorities
    _, priorities = nstep_kernel.td_loss_and_priorities_dispatch(
        q_values, q_values, action, action, rewards, done,
        gamma=config.discounting,
        n_steps=config.n_steps,
        rescaling_eps=config.value_function_rescaling_epsilon,
    )
    return priorities


def loss_inputs(
    net: torch.nn.Module,
    target_net: torch.nn.Module,
    agent_state,
    prev_actions,
    env_outputs,
    agent_outputs,
    burn_in: int,
):
    """The arguments of the TD loss on time-major [T_total, B] inputs:
    (online Q, target Q, online argmax, replayed action, rewards, done),
    each over the T_total - burn_in steps after the burn-in.

    The burn-in prefix warms both networks' recurrent state without
    gradients; gradients flow into ``net`` through the suffix unroll only.
    """
    if burn_in:
        prefix = pytree.tree_map(
            lambda t: t[:burn_in], (prev_actions, env_outputs))
        suffix = pytree.tree_map(
            lambda t: t[burn_in:], (prev_actions, env_outputs))
        agent_outputs = pytree.tree_map(lambda t: t[burn_in:], agent_outputs)
        with torch.no_grad():  # stop-gradient on the warmed-up states
            _, training_state = net.unroll(*prefix, agent_state)
            _, target_state = target_net.unroll(*prefix, agent_state)
    else:
        suffix = (prev_actions, env_outputs)
        training_state = target_state = agent_state

    training_output, _ = net.unroll(*suffix, training_state)
    with torch.no_grad():
        target_output, _ = target_net.unroll(*suffix, target_state)
    env_outputs_suffix = suffix[1]
    return (
        training_output.q_values,
        target_output.q_values,
        training_output.action,
        agent_outputs.action,
        env_outputs_suffix.reward,
        env_outputs_suffix.done,
    )


def compute_loss_and_priorities(
    net: torch.nn.Module,
    target_net: torch.nn.Module,
    agent_state,
    prev_actions,
    env_outputs,
    agent_outputs,
    gamma: float,
    burn_in: int,
    n_steps: int,
    eta: float = 0.9,
    rescaling_eps: float = 1e-3,
    target: str = "nstep",
    retrace_lambda: float = 0.95,
):
    """Burn-in + double-DQN sequence loss on time-major [T_total, B] inputs.

    Returns (loss f32[B], priorities f32[B]). ``target="retrace"`` swaps the
    n-step Bellman targets for Retrace(lambda) targets.
    """
    if target not in ("nstep", "retrace"):
        raise ValueError(f"unknown R2D2 target {target!r}")
    args = loss_inputs(net, target_net, agent_state, prev_actions,
                       env_outputs, agent_outputs, burn_in)
    if target == "retrace":
        return value_ops.retrace_loss_and_priorities(
            *args, gamma=gamma, lambda_=retrace_lambda, eta=eta,
            rescaling_eps=rescaling_eps,
        )
    return nstep_kernel.td_loss_and_priorities_dispatch(
        *args, gamma=gamma, n_steps=n_steps, eta=eta,
        rescaling_eps=rescaling_eps,
    )


def _mean_metrics(history: List[Dict[str, torch.Tensor]]):
    return {
        k: torch.mean(torch.stack([m[k] for m in history]))
        for k in history[0]
    }


class R2D2Update:
    """The online and target nets, the optimizer and one batch's update,
    shared by ``R2D2Learner`` and ``R2D2HostLearner``.

    Args:
      agent: an ``R2D2Agent`` whose network holds the online parameters.
      config: loss, replay and schedule knobs.
      optimizer: builds the optimizer from a parameter list, e.g.
        ``functools.partial(optim.ClippedAdam, learning_rate=1e-4,
        clip_norm=40.0)``; its ``step()`` returns the pre-clip norm.
      num_envs: the envs of a rollout, eval envs included.
      num_training_envs: how many of them train (default: all but
        ``config.num_eval_envs``; a rank's share of the envs holds its own
        count).
    """

    def __init__(self, agent: R2D2Agent, config: R2D2Config,
                 optimizer: Callable[[List[torch.Tensor]], Any],
                 num_envs: int, num_training_envs: Optional[int] = None):
        self.agent = agent
        self.config = config
        self.net = agent.net
        self.target_net = copy.deepcopy(agent.net).requires_grad_(False)
        self.optimizer = optimizer(self.parameters())
        self.num_envs = num_envs
        if num_envs - config.num_eval_envs <= 0 and num_training_envs is None:
            raise ValueError("num_eval_envs must leave some training envs")
        self.num_training_envs = (num_envs - config.num_eval_envs
                                  if num_training_envs is None
                                  else num_training_envs)

    def parameters(self) -> List[torch.nn.Parameter]:
        """Everything the optimizer updates: the online network."""
        return list(self.net.parameters())

    def _nets_and_optimizer(self) -> Dict[str, Any]:
        return dict(
            params={"net": self.net.state_dict()},
            target_params={"net": self.target_net.state_dict()},
            opt_state=self.optimizer.state_dict(),
        )

    def _load_nets_and_optimizer(self, tree: Dict[str, Any]):
        self.net.load_state_dict(tree["params"]["net"])
        self.target_net.load_state_dict(tree["target_params"]["net"])
        self.optimizer.load_state_dict(tree["opt_state"])

    def sync_target(self):
        """Hard update: target parameters <- online parameters."""
        with torch.no_grad():
            for t, p in zip(self.target_net.parameters(),
                            self.net.parameters()):
                t.copy_(p)

    def optimize(self, items: StoredUnroll, weights: torch.Tensor):
        """One optimization batch on item-major ``items``: burn-in loss
        weighted by ``weights``, clip + Adam on the online net. Returns
        (priorities f32[B], logs)."""
        config = self.config
        prev_actions, env_outputs, agent_outputs = _time_major(
            (items.prev_actions, items.env_outputs, items.agent_outputs))
        loss, priorities = compute_loss_and_priorities(
            self.net, self.target_net, items.agent_state,
            prev_actions, env_outputs, agent_outputs,
            gamma=config.discounting,
            burn_in=config.burn_in,
            n_steps=config.n_steps,
            rescaling_eps=config.value_function_rescaling_epsilon,
            target=config.target,
            retrace_lambda=config.retrace_lambda,
        )
        # Means over the batch: over every rank's share under a mesh.
        loss = collectives.mean(loss * weights)
        self.optimizer.zero_grad()
        loss.backward()
        grad_norm = self.optimizer.step()
        logs = {
            "losses/td": loss.detach(),
            "grad/norm": grad_norm,
            "replay/sampled_priority_mean": collectives.mean(priorities),
            "replay/importance_weight_mean": collectives.mean(weights),
        }
        return priorities, logs


class R2D2Learner(R2D2Update):
    """Fused on-device R2D2: rollout, insert, sample, loss, update.

    Args:
      engine: the rollout engine, with ``num_overlapping_steps = burn_in``
        (its env's device is the learner's).
      agent: an ``R2D2Agent`` whose network holds the online parameters.
      config: loss, replay and schedule knobs.
      optimizer: builds the optimizer from a parameter list, e.g.
        ``functools.partial(optim.ClippedAdam, learning_rate=1e-4,
        clip_norm=40.0)``; its ``step()`` returns the pre-clip norm.
      seed: seeds the generator of the replay's sampling.
    """

    # The train state's per-rank fields under a mesh (``parallel/dp.py``).
    SHARDED_FIELDS = {"replay": REPLAY_SHARDS, "rollout": ROLLOUT_SHARDS,
                      "stats": episode_stats.SHARDS,
                      "eval_stats": episode_stats.SHARDS}
    REPLICATED_FIELDS = ("step",)

    def __init__(
        self,
        engine: RolloutEngine,
        agent: R2D2Agent,
        config: R2D2Config,
        optimizer: Callable[[List[torch.Tensor]], Any],
        seed: int = 0,
    ):
        if engine.overlap != config.burn_in:
            raise ValueError(
                f"the rollout overlap ({engine.overlap}) must equal burn_in "
                f"({config.burn_in})")
        env = engine.env
        # The mesh of this rank's share of the envs (``parallel``).
        self.mesh = env.mesh
        # Training envs are the global ids below the eval envs'.
        training = env.global_num_envs - config.num_eval_envs
        if training <= 0:
            raise ValueError("num_eval_envs must leave some training envs")
        lo, hi = env.env_ids.start, env.env_ids.stop
        if config.batch_size % self.mesh.size:
            raise ValueError(f"batch_size={config.batch_size} does not "
                             f"divide over {self.mesh.size} replicas")
        super().__init__(agent, config, optimizer, env.num_envs,
                         min(max(training - lo, 0), hi - lo))
        self.engine = engine
        self.device = env.device
        if config.replay_buffer_min_size > config.replay_buffer_size:
            raise ValueError("replay_buffer_min_size exceeds the buffer")
        self.replay = PrioritizedReplay(
            config.replay_buffer_size, config.importance_sampling_exponent,
            mesh=self.mesh)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.frames_per_step = (
            engine.unroll_length * self.num_envs * self.mesh.size
            * config.num_action_repeats
        )

    def state_tensors(self, state: R2D2TrainState) -> List[torch.Tensor]:
        return pytree.tree_leaves((
            state.replay.buffer, state.replay.priorities, state.rollout,
            state.stats, state.eval_stats,
        ))

    def checkpoint_state(self, state: R2D2TrainState) -> Dict[str, Any]:
        """Everything a resumed run needs (``utils/checkpoint.py``): the
        train state's fields (the replay with its priorities and cursors
        among them), the online and target nets, the optimizer and every
        generator."""
        return dict(state._asdict(), **self._nets_and_optimizer(),
                    generators=generator_states(self))

    def load_checkpoint_state(self, state: R2D2TrainState,
                              tree: Dict[str, Any]) -> R2D2TrainState:
        """Takes back a tree of ``checkpoint_state``'s structure, whole or
        its warm-start fields only; returns the train state."""
        self._load_nets_and_optimizer(tree)
        return load_train_state(self, state, tree)

    def _example_item(self, rollout: RolloutState) -> StoredUnroll:
        """Zeros shaped like one replay item, from the primed rollout."""
        steps = self.engine.overlap + self.engine.unroll_length + 1
        ts = rollout.carry_timesteps

        def per_step(t):
            return torch.zeros((steps,) + tuple(t.shape[2:]), dtype=t.dtype,
                               device=t.device)

        return StoredUnroll(
            agent_state=pytree.tree_map(
                lambda t: torch.zeros_like(t[0]), rollout.agent_state),
            prev_actions=pytree.tree_map(per_step, ts.prev_action),
            env_outputs=pytree.tree_map(per_step, ts.env_output),
            agent_outputs=pytree.tree_map(per_step, ts.agent_output),
        )

    def init(self) -> R2D2TrainState:
        """Starts the rollout, an empty replay and the counters."""
        rollout = self.engine.init()
        # This rank's eval envs; without any, rank 0 holds the one
        # placeholder accumulator, so the ranks' concatenation is the
        # one-rank layout.
        num_eval = self.num_envs - self.num_training_envs
        if not self.config.num_eval_envs and self.mesh.rank == 0:
            num_eval = 1
        return R2D2TrainState(
            replay=self.replay.init_state(self._example_item(rollout)),
            rollout=rollout,
            stats=episode_stats.init(self.num_training_envs, self.device),
            eval_stats=episode_stats.init(num_eval, self.device),
            step=0,
        )

    def _rollout_and_insert(self, state: R2D2TrainState) -> R2D2TrainState:
        rollout, unroll = self.engine.rollout(state.rollout)
        items = unroll_to_items(unroll, self.num_training_envs)
        priorities = initial_priorities(self.config, items)
        replay, _ = self.replay.insert(state.replay, items, priorities)

        # Only the last T timesteps are new; the first overlap+1 are shared
        # with the previous unroll (already counted in the stats window).
        n = self.num_training_envs
        new_steps = pytree.tree_map(
            lambda x: x[self.engine.overlap + 1:], unroll.timesteps.env_output
        )
        stats = episode_stats.update(
            state.stats, pytree.tree_map(lambda x: x[:, :n], new_steps))
        eval_stats = state.eval_stats
        if self.config.num_eval_envs:
            eval_stats = episode_stats.update(
                eval_stats, pytree.tree_map(lambda x: x[:, n:], new_steps))
        return state._replace(
            rollout=rollout, replay=replay, stats=stats,
            eval_stats=eval_stats,
        )

    def warmup_step(self, state: R2D2TrainState) -> R2D2TrainState:
        """Rollout + insert only: fills the buffer to its min size."""
        return self._rollout_and_insert(state)

    def train_on_batch(
        self, state: R2D2TrainState, indices: Optional[torch.Tensor] = None
    ) -> Tuple[R2D2TrainState, Dict[str, torch.Tensor]]:
        """One optimization batch: sample (or take ``indices``), loss,
        clip + Adam on the online net, priority write-back."""
        config = self.config
        indices, weights, items = self.replay.sample(
            state.replay, self.generator, config.batch_size,
            config.priority_exponent, indices=indices,
        )
        # Every rank holds the global batch and trains on its share; the
        # priorities come back in the global batch order.
        part = self.mesh.shard(config.batch_size)
        priorities, logs = self.optimize(
            pytree.tree_map(lambda t: t[part], items), weights[part])
        priorities = self.mesh.all_gather(priorities)
        replay = self.replay.update_priorities(
            state.replay, indices, priorities)
        return state._replace(replay=replay), logs

    def train_step(
        self, state: R2D2TrainState
    ) -> Tuple[R2D2TrainState, Dict[str, torch.Tensor]]:
        state = self._rollout_and_insert(state)
        history = []
        for _ in range(self.config.train_batches_per_step):
            state, logs = self.train_on_batch(state)
            history.append(logs)
        step = state.step + 1
        if step % self.config.update_target_every_n_step == 0:
            self.sync_target()
        return state._replace(step=step), _mean_metrics(history)

    def train_many(
        self, state: R2D2TrainState, num_steps: int
    ) -> Tuple[R2D2TrainState, Dict[str, torch.Tensor]]:
        """Run ``num_steps`` train steps; metrics averaged over them."""
        history = []
        for _ in range(num_steps):
            state, metrics = self.train_step(state)
            history.append(metrics)
        return state, _mean_metrics(history)


class R2D2HostTrainState(NamedTuple):
    """The host learner's train state: the parameters, target parameters
    and optimizer state live on the nets and the optimizer, the replay and
    the rollout on the host."""

    step: int  # optimization batches (the reference's ``iterations``)


class R2D2HostLearner(R2D2Update):
    """R2D2 over host envs and a host-RAM replay, at the reference's scale.

    The sample-train half for ``host_offpolicy.host_offpolicy_loop``, whose
    ``HostRolloutEngine`` has ``num_overlapping_steps = burn_in``. The loss,
    targets and priorities are ``R2D2Learner``'s. The target net is synced
    every ``update_target_every_n_step`` optimization batches.
    """

    def __init__(self, agent: R2D2Agent, config: R2D2Config,
                 optimizer: Callable[[List[torch.Tensor]], Any],
                 num_envs: int, unroll_length: int):
        super().__init__(agent, config, optimizer, num_envs)
        self.device = next(agent.net.parameters()).device
        self.unroll_length = unroll_length
        self.frames_per_cycle = (
            unroll_length * num_envs * config.num_action_repeats)
        self.priority_exponent = config.priority_exponent
        self.batch_size = config.batch_size

    def init(self) -> R2D2HostTrainState:
        return R2D2HostTrainState(step=0)

    def state_tensors(self, state: R2D2HostTrainState) -> List[torch.Tensor]:
        return list(self.target_net.parameters())

    def checkpoint_state(self, state: R2D2HostTrainState) -> Dict[str, Any]:
        """The step, the online and target nets and the optimizer (the
        replay is saved beside the checkpoint, ``host_offpolicy.py``)."""
        return dict(state._asdict(), **self._nets_and_optimizer(),
                    generators=generator_states(self))

    def load_checkpoint_state(self, state: R2D2HostTrainState,
                              tree: Dict[str, Any]) -> R2D2HostTrainState:
        self._load_nets_and_optimizer(tree)
        return load_train_state(self, state, tree)

    def make_items_and_priorities(self, unroll: Unroll):
        """An unroll -> (replay items of the training envs, their initial
        priorities); the eval envs' experience is left out."""
        items = unroll_to_items(unroll, self.num_training_envs)
        return items, initial_priorities(self.config, items)

    def train_on_batch(self, state: R2D2HostTrainState, items: StoredUnroll,
                       weights: torch.Tensor):
        """One optimization batch on host-sampled items; returns (state,
        priorities f32[batch], logs)."""
        priorities, logs = self.optimize(items, weights)
        step = state.step + 1
        if step % self.config.update_target_every_n_step == 0:
            self.sync_target()
        return state._replace(step=step), priorities, logs


def learner_loop(
    learner: R2D2Learner,
    total_environment_frames: int,
    logger=None,
    checkpoint=None,
    log_every_steps: int = 10,
    steps_per_call: int = 1,
) -> Tuple[R2D2TrainState, Dict[str, Any]]:
    """Warm up to ``replay_buffer_min_size``, then train to the budget.

    Returns the final state and the metrics of the last call. Unlike
    V-trace, both episode-stat windows (training and eval envs) reset on
    every log line, as in the JAX package. With a ``checkpoint`` manager
    the loop restores on start (a restored replay that holds the minimum
    is not warmed up again), offers a save after every call and forces one
    at the end.
    """
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
            for name, stats in (
                ("episodes", state.stats),
                ("eval_episodes", state.eval_stats),
            ):
                n, sum_return, sum_length = episode_stats.window(
                    stats, learner.mesh)
                if n > 0:
                    metrics[f"{name}/mean_return"] = sum_return / n
                    metrics[f"{name}/mean_length"] = sum_length / n
            state = state._replace(
                stats=episode_stats.reset_window(state.stats),
                eval_stats=episode_stats.reset_window(state.eval_stats),
            )
            logger.log(step, metrics, frames=step * frames_per_step)
        if checkpoint is not None:
            checkpoint.maybe_save(step, learner, state)
    if checkpoint is not None:
        checkpoint.maybe_save(state.step, learner, state, force=True)
    return state, metrics
