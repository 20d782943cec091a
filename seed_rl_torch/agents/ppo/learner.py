"""On-policy (PPO-family) learner: on-device rollout, then epochs of
minibatch SGD.

Port of ``seed_rl_tpu/agents/ppo/learner.py``:
- one rollout of ``num_envs`` unrolls per train step, then
  ``epochs_per_step`` passes over it, each split into ``batches_per_step``
  minibatches;
- four batch modes: ``repeat`` (the same minibatch order every epoch),
  ``shuffle`` (unrolls reshuffled every epoch), ``split`` (advantages
  once, unrolls flattened to transitions and shuffled) and
  ``split_with_advantage_recomputation`` (advantages again every epoch).
  The split modes need a stateless net, and the minibatch size must divide
  T*B (split) or B (the others);
- the observation statistics are updated once per train step, before the
  epochs, and ride beside the parameters without being trained.

A minibatch step: the loss and its gradient at the current parameters,
then the loss-owned parameters take the values the loss reassigned (PopArt
compensation), then one global-norm clip and Adam over the net's and the
loss-owned parameters together, then the Lagrange multipliers are clipped.
Every parameter steps every time, with a zero gradient where the loss did
not reach it, as optax does (``optim.ClippedAdam``). Logs stay on the
device and are averaged there: the minibatch loop waits for no host sync.

Random streams: the permutations come from ``torch.randperm`` and the
regularizer's entropy noise from the learner's generator. ``update`` takes
both instead (``permutations``: one index tensor per epoch;
``entropy_noise``: one tensor per minibatch step), so a test can hold one
update against the JAX package's ``jax.random`` draws.
"""

import dataclasses
import itertools
import os
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.agents.ppo.generalized_onpolicy_loss import (
    GeneralizedOnPolicyLoss,
)
from seed_rl_torch.rollout import RolloutEngine, RolloutState, Unroll
from seed_rl_torch.utils import episode_stats
from seed_rl_torch.utils.action_points import (
    ActionPointSchedule,
    snapshot_ppo_state,
)
from seed_rl_torch.utils.checkpoint import generator_states, load_train_state

BATCH_MODES = (
    "repeat",
    "shuffle",
    "split",
    "split_with_advantage_recomputation",
)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    epochs_per_step: int = 1
    batch_mode: str = "split"
    batches_per_step: int = 1


class PPOTrainState(NamedTuple):
    norm_state: Any  # PopArt tracker state (not trained)
    rollout: RolloutState
    stats: episode_stats.EpisodeStatsState
    step: int  # train steps


class _Batch(NamedTuple):
    """What the minibatch steps train on: unrolls (agent state [B, ...],
    the rest time-major [T, B, ...]), or in the split modes transitions
    ([1, T*B, ...], no agent state) with their normalized targets and
    advantages, computed once before the minibatches."""

    agent_state: Any
    prev_actions: Any
    env_outputs: Any
    agent_outputs: Any
    targets: Optional[torch.Tensor] = None
    advantages: Optional[torch.Tensor] = None

    @property
    def size(self) -> int:
        return pytree.tree_leaves(self.prev_actions)[0].shape[1]

    def take(self, idx: torch.Tensor) -> "_Batch":
        """The minibatch of batch columns ``idx``."""
        def columns(tree):
            return (None if tree is None
                    else pytree.tree_map(lambda t: t[:, idx], tree))

        return _Batch(
            pytree.tree_map(lambda t: t[idx], self.agent_state),
            *(columns(tree) for tree in self[1:]))


def _mean_logs(history: List[Dict[str, torch.Tensor]]):
    return {k: torch.mean(torch.stack([h[k] for h in history]))
            for k in history[0]}


class PPOLearner:
    """Fused on-device PPO family: rollout, then epochs of minibatch SGD.

    Args:
      engine: the rollout engine (its env's device is the learner's).
      agent: a ``PolicyAgent`` or ``NormalizingPolicyAgent`` whose network
        holds the parameters.
      loss: the ``GeneralizedOnPolicyLoss``.
      config: epochs, batch mode and minibatches.
      optimizer: builds the optimizer from a parameter list, e.g.
        ``functools.partial(optim.ClippedAdam, learning_rate=3e-4,
        clip_norm=0.5)``; its ``step()`` returns the pre-clip norm.
      seed: seeds the generator of the permutations and the entropy noise.
    """

    def __init__(
        self,
        engine: RolloutEngine,
        agent,
        loss: GeneralizedOnPolicyLoss,
        config: PPOConfig,
        optimizer: Callable[[List[torch.Tensor]], Any],
        seed: int = 0,
    ):
        if config.batch_mode not in BATCH_MODES:
            raise ValueError(f"unknown batch mode {config.batch_mode!r}")
        if engine.overlap != 0:
            raise ValueError("PPO uses the 1-step boundary overlap only")
        split = config.batch_mode.startswith("split")
        if split and pytree.tree_leaves(agent.initial_state(1)):
            raise ValueError(
                "the split batch modes need a stateless net; use shuffle or "
                "repeat for a recurrent one")
        n = engine.env.num_envs * (engine.unroll_length if split else 1)
        if n % config.batches_per_step:
            raise ValueError(
                f"{config.batches_per_step} minibatches do not divide the "
                f"{n} {'transitions' if split else 'unrolls'} of a step")
        self.engine = engine
        self.agent = agent
        self.loss = loss
        self.config = config
        self.device = engine.device
        self.loss_params = pytree.tree_map(
            lambda t: torch.nn.Parameter(t.to(self.device)),
            loss.init_params(self.device))
        self.optimizer = optimizer(self.parameters())
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.frames_per_step = engine.unroll_length * engine.env.num_envs
        # The in-memory snapshots ``learner_loop`` takes at its action
        # points (``utils/action_points.LearnerState``).
        self.snapshots = []

    def parameters(self) -> List[torch.nn.Parameter]:
        """Everything the optimizer updates: the net and the loss-owned
        parameters."""
        return (list(self.agent.net.parameters())
                + pytree.tree_leaves(self.loss_params))

    def state_tensors(self, state: PPOTrainState) -> List[torch.Tensor]:
        return pytree.tree_leaves((
            state.norm_state, state.rollout or (), state.stats,
            getattr(self.agent, "obs_norm", ())))

    def checkpoint_state(self, state: PPOTrainState) -> Dict[str, Any]:
        """Everything a resumed run needs (``utils/checkpoint.py``): the
        train state's fields (the PopArt state among them), the net and the
        loss-owned parameters, the optimizer, the input statistics (None
        without) and every generator."""
        return dict(
            state._asdict(),
            params={"net": self.agent.net.state_dict(),
                    "loss": pytree.tree_map(torch.Tensor.detach,
                                            self.loss_params)},
            opt_state=self.optimizer.state_dict(),
            obs_norm=getattr(self.agent, "obs_norm", None),
            generators=generator_states(self),
        )

    def load_checkpoint_state(self, state: PPOTrainState,
                              tree: Dict[str, Any]) -> PPOTrainState:
        """Takes back a tree of ``checkpoint_state``'s structure, whole or
        its warm-start fields only; returns the train state."""
        self.agent.net.load_state_dict(tree["params"]["net"])
        self._assign_loss_params(tree["params"]["loss"])
        self.optimizer.load_state_dict(tree["opt_state"])
        if tree["obs_norm"] is not None:
            self.agent.obs_norm = tree["obs_norm"]
        return load_train_state(self, state, tree)

    def init(self) -> PPOTrainState:
        return PPOTrainState(
            norm_state=self.loss.init_norm_state(self.device),
            # A host engine's rollout state stays outside (host_loop.py).
            rollout=None if self.engine.is_host else self.engine.init(),
            stats=episode_stats.init(self.engine.env.num_envs, self.device),
            step=0,
        )

    # -- the minibatch step ---------------------------------------------------

    def _minibatch_step(self, norm_state, minibatch: _Batch, noise):
        self.optimizer.zero_grad()
        loss, aux = self.loss(
            self.loss_params, norm_state, minibatch.agent_state,
            minibatch.prev_actions, minibatch.env_outputs,
            minibatch.agent_outputs, generator=self.generator, noise=noise,
            normalized_targets=minibatch.targets,
            normalized_advantages=minibatch.advantages)
        loss.backward()
        # The gradient was taken at the old values; Adam's update applies to
        # the values the loss reassigned.
        self._assign_loss_params(aux.loss_params)
        grad_norm = self.optimizer.step()
        self.loss.postprocess_params_(self.loss_params)
        logs = {k: v.detach() for k, v in aux.logs.items()}
        logs["grad/norm"] = grad_norm
        return aux.norm_state, logs

    @torch.no_grad()
    def _assign_loss_params(self, new_params):
        for param, value in zip(pytree.tree_leaves(self.loss_params),
                                pytree.tree_leaves(new_params)):
            if value is not param:
                param.copy_(value)

    def _epoch(self, norm_state, data: _Batch, shuffle, permutation, noises):
        """One pass over ``data`` in ``batches_per_step`` minibatches."""
        if permutation is None:
            permutation = (
                torch.randperm(data.size, generator=self.generator,
                               device=self.device)
                if shuffle else torch.arange(data.size, device=self.device))
        history = []
        for idx in permutation.to(self.device).reshape(
                self.config.batches_per_step, -1):
            norm_state, logs = self._minibatch_step(
                norm_state, data.take(idx), next(noises))
            history.append(logs)
        return norm_state, history

    @torch.no_grad()
    def _compute_and_split(self, norm_state, unrolls: _Batch):
        """Advantages once, then the unrolls flattened into transitions
        ([1, T*B])."""
        targets, advantages, norm_state, new_loss_params, logs = (
            self.loss.compute_advantages(
                self.loss_params, norm_state, *unrolls[:4],
                generator=self.generator))
        self._assign_loss_params(new_loss_params)
        flat = pytree.tree_map(
            lambda t: t.reshape((1, t.shape[0] * t.shape[1]) + t.shape[2:]),
            pytree.tree_map(lambda t: t[:-1], tuple(unrolls[1:4]))
            + (targets, advantages))
        return _Batch((), *flat), norm_state, logs

    # -- the train step -------------------------------------------------------

    def update(
        self,
        state: PPOTrainState,
        unroll: Unroll,
        permutations: Optional[List[torch.Tensor]] = None,
        entropy_noise: Optional[List[torch.Tensor]] = None,
    ) -> Tuple[PPOTrainState, Dict[str, torch.Tensor]]:
        """The full optimization pass on one collected unroll batch."""
        config = self.config
        if hasattr(self.agent, "update_observation_normalization"):
            self.agent.update_observation_normalization(
                unroll.timesteps.env_output.observation)
        ts = unroll.timesteps
        unrolls = _Batch(unroll.agent_state, ts.prev_action, ts.env_output,
                         ts.agent_output)
        noises = iter(entropy_noise if entropy_noise is not None
                      else itertools.repeat(None))
        norm_state = state.norm_state
        adv_logs, history = {}, []
        data = None
        for epoch in range(config.epochs_per_step):
            permutation = permutations[epoch] if permutations else None
            if config.batch_mode.startswith("split"):
                if data is None or config.batch_mode != "split":
                    data, norm_state, logs = self._compute_and_split(
                        norm_state, unrolls)
                    if epoch == 0 and config.batch_mode == "split":
                        adv_logs = logs
                norm_state, logs = self._epoch(norm_state, data, True,
                                               permutation, noises)
            else:
                norm_state, logs = self._epoch(
                    norm_state, unrolls, config.batch_mode == "shuffle",
                    permutation, noises)
            history.extend(logs)

        stats = episode_stats.update(
            state.stats, pytree.tree_map(lambda x: x[1:], ts.env_output))
        metrics = dict(adv_logs)
        metrics.update(_mean_logs(history))
        return state._replace(norm_state=norm_state, stats=stats,
                              step=state.step + 1), metrics

    def train_step(
        self, state: PPOTrainState
    ) -> Tuple[PPOTrainState, Dict[str, torch.Tensor]]:
        rollout, unroll = self.engine.rollout(state.rollout)
        return self.update(state._replace(rollout=rollout), unroll)

    def train_many(
        self, state: PPOTrainState, num_steps: int
    ) -> Tuple[PPOTrainState, Dict[str, torch.Tensor]]:
        """Run ``num_steps`` train steps; metrics averaged over them."""
        history = []
        for _ in range(num_steps):
            state, metrics = self.train_step(state)
            history.append(metrics)
        return state, _mean_logs(history)


def learner_loop(
    learner: PPOLearner,
    total_environment_frames: int,
    logger=None,
    checkpoint=None,
    log_every_steps: int = 10,
    steps_per_call: int = 1,
    num_checkpoints: int = 0,
    num_saved_models: int = 0,
    num_snapshots: int = 0,
    logdir: Optional[str] = None,
) -> Tuple[PPOTrainState, Dict[str, Any]]:
    """Train until the frame budget, logging ``episodes/mean_return`` over
    the window since the last log line (the JAX CLI's PPO loop). Returns
    the final state and the metrics of the last call.

    With a ``checkpoint`` manager the loop restores on start, offers a save
    after every call and forces one at the end. The action points fire at
    ``linspace(0, total_environment_frames, n + 1)[1:]`` frames, once per
    mark crossed: ``num_checkpoints`` forced saves and ``num_saved_models``
    policy exports to ``<logdir>/saved_models/<frames>`` (only with a
    ``logdir``), each at most once per call, and ``num_snapshots``
    in-memory snapshots, one per mark, appended to ``learner.snapshots``.
    """
    state = learner.init()
    if checkpoint is not None:
        state = checkpoint.restore_or(learner, state)
    schedule = ActionPointSchedule(total_environment_frames, {
        "checkpoint": num_checkpoints,
        "saved_model": num_saved_models,
        "snapshot": num_snapshots,
    })
    metrics: Dict[str, Any] = {}
    frames_per_step = learner.frames_per_step
    while state.step * frames_per_step < total_environment_frames:
        state, metrics = learner.train_many(state, steps_per_call)
        step = state.step
        frames = step * frames_per_step
        if logger is not None and step % log_every_steps < steps_per_call:
            metrics = dict(metrics)
            n = float(state.stats.num_episodes)
            if n > 0:
                metrics["episodes/mean_return"] = (
                    float(state.stats.sum_return) / n)
                state = state._replace(
                    stats=episode_stats.reset_window(state.stats))
            logger.log(step, metrics, frames=frames)
        fired = schedule.due(frames)
        # Jumped marks repeat in ``fired``: the same state saved or
        # exported twice is pointless, so those two fire once a call, while
        # snapshots honour the requested count.
        if "checkpoint" in fired and checkpoint is not None:
            checkpoint.maybe_save(step, learner, state, force=True)
        if "saved_model" in fired and logdir:
            from seed_rl_torch.utils.export import export_policy

            export_policy(os.path.join(logdir, "saved_models", str(frames)),
                          learner.agent, state.rollout.prev_action,
                          state.rollout.env_output)
        learner.snapshots.extend(
            snapshot_ppo_state(learner, state, frames)
            for _ in range(fired.count("snapshot")))
        if checkpoint is not None:
            checkpoint.maybe_save(step, learner, state)
    if checkpoint is not None:
        checkpoint.maybe_save(state.step, learner, state, force=True)
    return state, metrics
