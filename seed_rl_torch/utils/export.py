"""Code-independent policy export.

Port of ``seed_rl_tpu/utils/export.py``, which serializes the jitted
policy step as StableHLO with its parameters. Here the policy step is
captured with ``torch.export`` and saved with ``torch.export.save`` to
``<directory>/policy.pt2``: the program and, as its state, the net's
parameters, a normalizing agent's observation statistics and an
epsilon-greedy agent's per-env epsilons. ``load_policy`` runs it without
the model-building code.

The inputs and outputs are NamedTuple trees (``EnvOutput``, Atari's
``AgentState`` with its frame stack); each is registered for serialization
under a stable name, the counterpart of the JAX package's
``_register_pytree_serialization``.

A sampling policy (``deterministic=False``) takes its random draws as an
input, ``draws``: a tuple with one tensor per draw the agent's
``policy_step`` makes (a distribution's Gumbel or standard normal noise,
one per sub-distribution of a joint one; R2D2's random actions and
uniforms). A ``torch.Generator`` cannot cross ``torch.export``, so the
program holds none; its recipe (each draw's kind, shape and dtype) is
saved beside it, and the loaded policy draws each one from the caller's
generator with the calls, in the order, that ``policy_step(...,
generator=rng)`` makes: the same seed gives the same actions. A
deterministic program takes no draws and ignores ``rng``, as JAX's does.
"""

import copy
import json
import os

import torch
import torch.utils._pytree as pytree

from seed_rl_torch import distributions as pd

FILE_NAME = "policy.pt2"
# The recipe of the program's draws, saved inside policy.pt2.
META_NAME = "policy.json"


def _register_pytree_serialization():
    """Registers the NamedTuples a policy step takes or returns with
    ``torch.utils._pytree`` under stable names (idempotent)."""
    from seed_rl_torch.models.atari import AgentState
    from seed_rl_torch.types import AgentOutput, EnvOutput, QAgentOutput

    for cls in (EnvOutput, AgentOutput, QAgentOutput, AgentState):
        if cls not in pytree.SUPPORTED_NODES:
            pytree._register_namedtuple(
                cls, serialized_type_name=f"seed_rl_torch.{cls.__name__}")


def _draw_leaves(recipe):
    """A recipe's ``Draw`` leaves in order (a recipe is a ``Draw``, None,
    or a list or tuple of recipes)."""
    if recipe is None:
        return []
    if isinstance(recipe, pd.Draw):
        return [recipe]
    return [leaf for r in recipe for leaf in _draw_leaves(r)]


def _fill(recipe, values):
    """The recipe's tree with its leaves taken in order from ``values``."""
    if recipe is None:
        return None
    if isinstance(recipe, pd.Draw):
        return next(values)
    return type(recipe)(_fill(r, values) for r in recipe)


class _PolicyStep(torch.nn.Module):
    """``agent.policy_step`` as a module: the net is its submodule, the
    observation statistics and an epsilon-greedy agent's epsilons its
    buffers. A sampling step takes ``draws``, the flat tuple of the
    recipe's leaves, and hands them to ``policy_step`` as its noise."""

    def __init__(self, agent, deterministic, recipe):
        super().__init__()
        self.net = agent.net
        self._deterministic = deterministic
        self._epsilon_greedy = hasattr(agent, "epsilons")
        self._recipe = recipe
        # A copy whose statistics ``forward`` points at the buffers.
        self._agent = copy.copy(agent)
        stats = getattr(agent, "obs_norm", None) or ()
        leaves, self._stats_spec = pytree.tree_flatten(stats)
        self._num_stats = len(leaves)
        for i, leaf in enumerate(leaves):
            self.register_buffer(f"obs_norm_{i}", leaf.detach().clone())
        if self._epsilon_greedy and not deterministic:
            self.register_buffer("epsilons", agent.epsilons.detach().clone())

    def forward(self, prev_action, env_output, core_state, draws):
        if self._num_stats:
            self._agent.obs_norm = pytree.tree_unflatten(
                [getattr(self, f"obs_norm_{i}")
                 for i in range(self._num_stats)], self._stats_spec)
        kwargs = {}
        if not self._deterministic:
            noise = _fill(self._recipe, iter(draws))
            if self._epsilon_greedy:
                self._agent.epsilons = self.epsilons
                kwargs = dict(random_actions=noise[0], uniform=noise[1])
            else:
                kwargs = dict(noise=noise)
        output, new_state = self._agent.policy_step(
            prev_action, env_output, core_state,
            deterministic=self._deterministic, **kwargs)
        return output.action, new_state


def _recipe(agent, output):
    """The draws of ``agent``'s sampling step, in its order, from one
    deterministic step's output: an epsilon-greedy agent's by its batch,
    a policy's by its distribution's parameters."""
    if hasattr(agent, "epsilons"):
        return agent.draws(output.action.shape[0])
    return agent.distribution.draws(output.policy_logits)


def export_policy(directory: str, agent, example_prev_action,
                  example_env_output, deterministic: bool = True):
    """Serializes the agent's policy step (its mode with
    ``deterministic``, else its sampling step) and its state to
    ``directory`` at the example's batch size, shapes and device."""
    _register_pytree_serialization()
    batch = pytree.tree_leaves(example_env_output.observation)[0].shape[0]
    # Distinct tensors: torch.export traces aliased inputs as one, and an
    # initial state may repeat one zeros tensor (ActorCriticLSTM's carries).
    core_state = pytree.tree_map(torch.clone, agent.initial_state(batch))
    recipe = None
    if not deterministic:
        with torch.no_grad():
            output, _ = agent.policy_step(example_prev_action,
                                          example_env_output, core_state,
                                          deterministic=True)
        recipe = _recipe(agent, output)
    leaves = _draw_leaves(recipe)
    device = example_prev_action.device
    generator = torch.Generator(device=device).manual_seed(0)
    draws = tuple(pd.draw(d, generator, device) for d in leaves)
    with torch.no_grad():
        program = torch.export.export(
            _PolicyStep(agent, deterministic, recipe),
            (example_prev_action, example_env_output, core_state, draws))
    # The example inputs are NamedTuples, which a weights-only load of the
    # program refuses; the program needs none of them.
    program.example_inputs = None
    meta = {"deterministic": deterministic, "device": str(device),
            "draws": [{"kind": d.kind, "shape": list(d.shape),
                       "dtype": str(d.dtype).removeprefix("torch."),
                       "high": d.high} for d in leaves]}
    os.makedirs(directory, exist_ok=True)
    torch.export.save(program, os.path.join(directory, FILE_NAME),
                      extra_files={META_NAME: json.dumps(meta)})


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    return a.type == "cpu" or (a.index or 0) == (b.index or 0)


class ExportedPolicy:
    """A loaded policy: ``policy(prev_action, env_output, core_state,
    rng=None) -> (action, new_core_state)``. ``draw(rng)`` makes a
    sampling program's draws and ``step`` runs the program on given ones
    (another package's draws, say)."""

    def __init__(self, module, meta):
        self._module = module
        self.deterministic = meta["deterministic"]
        self.device = torch.device(meta["device"])
        self.recipe = [pd.Draw(d["kind"], tuple(d["shape"]),
                               getattr(torch, d["dtype"]), d["high"])
                       for d in meta["draws"]]

    def draw(self, rng: torch.Generator):
        """The program's draws from ``rng``, as ``policy_step(...,
        generator=rng)`` makes them."""
        if not isinstance(rng, torch.Generator):
            raise ValueError("a sampling policy needs a torch.Generator as "
                             f"its rng, got {rng!r}")
        if not _same_device(rng.device, self.device):
            raise ValueError(f"the rng draws on {rng.device}; the program "
                             f"runs on {self.device}")
        return tuple(pd.draw(d, rng, self.device) for d in self.recipe)

    def step(self, prev_action, env_output, core_state, draws=()):
        with torch.no_grad():
            return self._module(prev_action, env_output, core_state,
                                tuple(draws))

    def __call__(self, prev_action, env_output, core_state, rng=None):
        draws = () if self.deterministic else self.draw(rng)
        return self.step(prev_action, env_output, core_state, draws)


def load_policy(directory: str) -> ExportedPolicy:
    """Loads an exported policy; returns ``fn(prev_action, env_output,
    core_state, rng=None) -> (action, new_core_state)``. A sampling
    policy needs ``rng``, a ``torch.Generator`` on the program's device,
    and raises ``ValueError`` without one."""
    _register_pytree_serialization()
    extra = {META_NAME: ""}
    program = torch.export.load(os.path.join(directory, FILE_NAME),
                                extra_files=extra)
    return ExportedPolicy(program.module(), json.loads(extra[META_NAME]))
