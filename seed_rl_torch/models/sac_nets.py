"""SAC actor-critic networks.

Port of ``seed_rl_tpu/models/sac_nets.py``:
- ``ActorCriticMLP``: an actor MLP giving the distribution's parameters,
  ``n_critics`` Q-MLPs over ``[observation, action]`` and a V-MLP. A dict
  observation is concatenated along its last axis in sorted key order.
- ``VisualActorCritic``: a Nature-DQN conv torso (``models/atari.py``)
  shared by the actor, V and Q heads over uint8 frames, with the
  ``get_embedding`` / ``*_from_embedding`` split that lets the loss run the
  torso once per parameter set. Leading dims fold into one batch dim for the
  convs.
- ``LSTMWithFeedForwardBranch`` and ``ActorCriticLSTM``: per net a pre-MLP
  into a stacked LSTM (the carry resets where ``done`` is set, before the
  step) beside a feed-forward MLP, both into a post-MLP. A goal-env dict
  observation withholds ``desired_goal`` from the recurrent branch (it
  changes when HER relabels a window); the Q nets feed ``[observation,
  action]`` to the feed-forward branch, the actor and V the observation.

Every MLP's last layer is linear. Method names are the JAX package's
(its ``__call__``, flax's init entry, has no counterpart):
``get_action_params``, ``get_v`` and ``get_q`` take ``(prev_action,
env_output, state[, action])``; the recurrent net's are time-major ``[T,
B, ...]`` and its ``step`` is a length-1 time-major call on ``[B, ...]``
inputs, so it shares parameters and reset semantics with them. Unlike
flax, a module is told its input widths up front: each net takes the env's
``observation_spec()`` (a ``TensorSpec`` or a dict of them). Parameters are
drawn on the CPU from a generator seeded with ``seed`` and then moved, as
in ``models/policy.py``; ``models/convert.py`` carries flax's over.
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.utils._pytree as pytree

from seed_rl_torch.device import resolve_device
from seed_rl_torch.models.atari import AtariConvTorso
from seed_rl_torch.models.core import LSTMStack, dense, lstm_initial_state
from seed_rl_torch.models.policy import _generator
from seed_rl_torch.ops.normalizer import observation_width

GOAL_KEYS = ("achieved_goal", "desired_goal", "observation")


def _concat_obs(observation) -> torch.Tensor:
    """f32 observation; a dict's leaves concatenated in sorted key order."""
    if isinstance(observation, dict):
        return torch.cat([observation[k].to(torch.float32)
                          for k in sorted(observation)], dim=-1)
    return observation.to(torch.float32)


def _recurrent_obs(observation) -> torch.Tensor:
    """The observation of the recurrent branch: no ``desired_goal``."""
    if isinstance(observation, dict):
        if not set(GOAL_KEYS) <= set(observation):
            raise ValueError("dict observations of the recurrent SAC net "
                             f"need the goal-env keys {GOAL_KEYS}")
        observation = {k: v for k, v in observation.items()
                       if k != "desired_goal"}
    return _concat_obs(observation)


def _with_action(x: torch.Tensor, action) -> torch.Tensor:
    """``[x, action]``; a scalar (discrete) action gets a trailing axis."""
    action = action.to(torch.float32)
    if action.dim() < x.dim():
        action = action[..., None]
    return torch.cat([x, action], dim=-1)


def _action_dim(param_size: int, action_dim: Optional[int]) -> int:
    # loc/scale continuous distributions; pass 1 for a categorical policy.
    return param_size // 2 if action_dim is None else action_dim


class _MLP(nn.Module):
    """Dense layers with ReLU between them and a linear last layer."""

    def __init__(self, input_size: int, sizes: Sequence[int],
                 generator: torch.Generator):
        super().__init__()
        widths = [input_size] + list(sizes)
        self.layers = nn.ModuleList(
            dense(a, b, generator) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            if i:
                x = torch.relu(x)
            x = layer(x)
        return x


class _Heads(nn.Module):
    """Actor, V and ``n_critics`` Q MLPs over a feature vector."""

    def _init_heads(self, feature_size, param_size, n_critics, sizes,
                    action_dim, generator):
        self.action_dim = _action_dim(param_size, action_dim)
        self.actor = _MLP(feature_size, tuple(sizes) + (param_size,),
                          generator)
        self.q = nn.ModuleList(
            _MLP(feature_size + self.action_dim, tuple(sizes) + (1,),
                 generator) for _ in range(n_critics))
        self.v = _MLP(feature_size, tuple(sizes) + (1,), generator)

    @property
    def stateless(self) -> bool:
        return True

    def initial_state(self, batch_size: int):
        del batch_size
        return ()

    def _action_params(self, features):
        return self.actor(features)

    def _v(self, features):
        return self.v(features).squeeze(-1)

    def _q(self, features, action):
        inputs = _with_action(features, action)
        return torch.cat([critic(inputs) for critic in self.q], dim=-1)


class ActorCriticMLP(_Heads):
    def __init__(
        self,
        parametric_distribution_param_size: int,
        observation_spec,
        n_critics: int = 2,
        mlp_sizes: Sequence[int] = (256, 256),
        action_dim: Optional[int] = None,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self._init_heads(observation_width(observation_spec),
                         parametric_distribution_param_size, n_critics,
                         mlp_sizes, action_dim, _generator(seed))
        self.to(device)

    def get_action_params(self, prev_action, env_output, state):
        del prev_action, state
        return self._action_params(_concat_obs(env_output.observation))

    def get_v(self, prev_action, env_output, state):
        del prev_action, state
        return self._v(_concat_obs(env_output.observation))

    def get_q(self, prev_action, env_output, state, action):
        del prev_action, state
        return self._q(_concat_obs(env_output.observation), action)


class VisualActorCritic(_Heads):
    """Shared Nature-DQN torso over uint8 ``[..., H, W, C]`` frames and MLP
    heads; the Q heads concatenate the action with the embedding."""

    def __init__(
        self,
        parametric_distribution_param_size: int,
        observation_spec,
        n_critics: int = 2,
        head_sizes: Sequence[int] = (256,),
        action_dim: Optional[int] = None,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        generator = _generator(seed)
        h, w, channels = observation_spec.shape
        self.torso = AtariConvTorso(channels, (h, w), generator)
        self._init_heads(self.torso.dense.out_features,
                         parametric_distribution_param_size, n_critics,
                         head_sizes, action_dim, generator)
        self.to(device)

    def get_embedding(self, prev_action, env_output, state):
        """The torso's embedding, computed once and reused by every head
        (``SACAgent.embed`` and the heads' ``embedding=``)."""
        del prev_action, state
        frames = env_output.observation
        lead = frames.shape[:-3]
        emb = self.torso(frames.reshape((-1,) + tuple(frames.shape[-3:])))
        return emb.reshape(tuple(lead) + (emb.shape[-1],))

    def get_action_params_from_embedding(self, emb):
        return self._action_params(emb)

    def get_v_from_embedding(self, emb):
        return self._v(emb)

    def get_q_from_embedding(self, emb, action):
        return self._q(emb, action)

    def get_action_params(self, prev_action, env_output, state):
        return self._action_params(
            self.get_embedding(prev_action, env_output, state))

    def get_v(self, prev_action, env_output, state):
        return self._v(self.get_embedding(prev_action, env_output, state))

    def get_q(self, prev_action, env_output, state, action):
        return self._q(self.get_embedding(prev_action, env_output, state),
                       action)


class LSTMWithFeedForwardBranch(nn.Module):
    """pre-MLP -> LSTM stack, beside a feed-forward MLP, -> post-MLP.

    Time-major ``[T, B, ...]`` inputs; ``done[t]`` resets the carry before
    timestep t is consumed.
    """

    def __init__(
        self,
        output_size: int,
        ff_input_size: int,
        recurrent_input_size: int,
        generator: torch.Generator,
        lstm_sizes: Sequence[int] = (256,),
        pre_mlp_sizes: Sequence[int] = (256,),
        post_mlp_sizes: Sequence[int] = (256,),
        ff_mlp_sizes: Sequence[int] = (256,),
    ):
        super().__init__()
        self.lstm_sizes = tuple(lstm_sizes)
        self.pre_mlp = _MLP(recurrent_input_size, pre_mlp_sizes, generator)
        self.core = LSTMStack(pre_mlp_sizes[-1], lstm_sizes, generator)
        self.ff_mlp = _MLP(ff_input_size, ff_mlp_sizes, generator)
        self.post_mlp = _MLP(ff_mlp_sizes[-1] + self.lstm_sizes[-1],
                             tuple(post_mlp_sizes) + (output_size,),
                             generator)

    def forward(self, ff_input, recurrent_input, state, done,
                only_return_new_state: bool = False):
        lstm_input = self.pre_mlp(recurrent_input)
        outputs = []
        for t in range(lstm_input.shape[0]):
            out, state = self.core(lstm_input[t], state, done[t])
            outputs.append(out)
        if only_return_new_state:
            return state
        post_input = torch.cat([self.ff_mlp(ff_input), torch.stack(outputs)],
                               dim=-1)
        return self.post_mlp(post_input), state


class ActorCriticLSTM(nn.Module):
    """Recurrent SAC net: one ``LSTMWithFeedForwardBranch`` each for the
    actor, V and the ``n_critics`` Q nets, and one carry each, in the order
    ``(actor, v, q_0, q_1, ...)``."""

    def __init__(
        self,
        parametric_distribution_param_size: int,
        observation_spec,
        n_critics: int = 2,
        lstm_sizes: Sequence[int] = (256,),
        pre_mlp_sizes: Sequence[int] = (256,),
        post_mlp_sizes: Sequence[int] = (256,),
        ff_mlp_sizes: Sequence[int] = (256,),
        action_dim: Optional[int] = None,
        seed: int = 0,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        generator = _generator(seed)
        param_size = parametric_distribution_param_size
        self.action_dim = _action_dim(param_size, action_dim)
        self.lstm_sizes = tuple(lstm_sizes)
        obs_size = observation_width(observation_spec)
        # The recurrent branch sees no desired goal, and the previous
        # action, as wide as the action.
        recurrent_size = obs_size + self.action_dim
        if isinstance(observation_spec, dict):
            recurrent_size -= observation_spec["desired_goal"].shape[-1]

        def create_net(output_size, ff_input_size):
            return LSTMWithFeedForwardBranch(
                output_size, ff_input_size, recurrent_size, generator,
                lstm_sizes=lstm_sizes, pre_mlp_sizes=pre_mlp_sizes,
                post_mlp_sizes=post_mlp_sizes, ff_mlp_sizes=ff_mlp_sizes)

        self.actor = create_net(param_size, obs_size)
        self.v = create_net(1, obs_size)
        self.q = nn.ModuleList(create_net(1, obs_size + self.action_dim)
                               for _ in range(n_critics))
        self.to(device)

    @property
    def stateless(self) -> bool:
        return False

    def _nets(self):
        return [self.actor, self.v, *self.q]

    def initial_state(self, batch_size: int):
        device = self.v.post_mlp.layers[-1].weight.device
        per_net = lstm_initial_state(self.lstm_sizes, batch_size, device)
        return tuple(per_net for _ in self._nets())

    @staticmethod
    def _recurrent_input(prev_action, env_output):
        return _with_action(_recurrent_obs(env_output.observation),
                            prev_action)

    def get_action_params(self, prev_action, env_output, state):
        out, _ = self.actor(_concat_obs(env_output.observation),
                            self._recurrent_input(prev_action, env_output),
                            state[0], env_output.done)
        return out

    def get_v(self, prev_action, env_output, state):
        v, _ = self.v(_concat_obs(env_output.observation),
                      self._recurrent_input(prev_action, env_output),
                      state[1], env_output.done)
        return v.squeeze(-1)

    def get_q(self, prev_action, env_output, state, action):
        ff_input = _with_action(_concat_obs(env_output.observation), action)
        recurrent_input = self._recurrent_input(prev_action, env_output)
        return torch.cat([
            net(ff_input, recurrent_input, net_state, env_output.done)[0]
            for net, net_state in zip(self.q, state[2:])
        ], dim=-1)

    def step(self, prev_action, env_output, state) -> Tuple[torch.Tensor,
                                                           Tuple]:
        """One rollout step on ``[B, ...]`` inputs: the actor's parameters
        ``[B, P]`` and every net's carry advanced."""
        t_env = pytree.tree_map(lambda x: x[None], env_output)
        recurrent_input = self._recurrent_input(prev_action[None], t_env)
        action_params, actor_state = self.actor(
            _concat_obs(t_env.observation), recurrent_input, state[0],
            t_env.done)
        new_states = [actor_state] + [
            net(None, recurrent_input, net_state, t_env.done,
                only_return_new_state=True)
            for net, net_state in zip(self._nets()[1:], state[1:])
        ]
        return action_params[0], tuple(new_states)
