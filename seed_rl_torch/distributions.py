"""Parametric action distributions in PyTorch.

Port of ``seed_rl_tpu/distributions.py``: each distribution is a stateless
object whose methods are functions of the parameter tensor. Sampling takes
an explicit ``torch.Generator`` (or a rank's ``parallel.draws.ShardedGenerator``);
``sample`` and ``entropy`` also take an
optional ``noise`` tensor, which replaces the draw (standard normal noise
for the normals, Gumbel noise for the categoricals). The tests hand both
packages the same noise, since ``jax.random`` and ``torch.Generator``
streams differ.

``draws(parameters)`` names the draws ``sample`` makes from a generator
(a ``Draw`` each: kind, shape and dtype), and ``draw`` makes one with
the same calls: an exported sampling policy takes its noise as an input
and its caller draws it by this recipe (``utils/export.py``).

``get_parametric_distribution_for_action_space`` dispatches by duck typing
(``spaces``, ``nvec``, ``n``, ``low``/``high``), so a gymnasium space and
the port's own ``seed_rl_torch.envs.spaces.Box`` both work, and nothing
here imports gymnasium.
"""

import abc
import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from seed_rl_torch.parallel import draws

_HALF_LOG_2PI_E = 0.5 * math.log(2.0 * math.pi * math.e)


class ParametricDistribution(abc.ABC):
    """Maps actor-network parameter vectors to a distribution over actions."""

    def __init__(self, param_size: int, reparametrizable: bool):
        self._param_size = param_size
        self._reparametrizable = reparametrizable

    @property
    def param_size(self) -> int:
        return self._param_size

    @property
    def reparametrizable(self) -> bool:
        return self._reparametrizable

    @abc.abstractmethod
    def sample(self, parameters, generator=None, noise=None):
        """Draws an action sample; differentiable iff reparametrizable."""

    @abc.abstractmethod
    def log_prob(self, parameters, actions):
        """Log-probability of ``actions`` (event dims reduced)."""

    @abc.abstractmethod
    def entropy(self, parameters, generator=None, noise=None):
        """Entropy (may be a single-sample estimate; see tanh variants)."""

    @abc.abstractmethod
    def kl_divergence(self, parameters_a, parameters_b):
        """KL(a || b), event dims reduced."""

    @abc.abstractmethod
    def mode(self, parameters):
        """Deterministic action (used for deterministic/eval inference)."""

    def draws(self, parameters):
        """The draws ``sample`` makes from a generator for ``parameters``,
        in its order: a ``Draw``, a list of them (or of None) for a joint
        distribution, or None where it draws nothing. Its tree is the
        ``noise`` that ``sample`` takes."""
        raise NotImplementedError(
            f"{type(self).__name__} names no draws: its sampling step "
            "cannot be exported")


class Draw(NamedTuple):
    """One random draw of a sampling step: its kind ("gumbel", "normal",
    "uniform" in [0, 1), or "randint" in [0, high)), shape and dtype."""

    kind: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    high: int = 0


def draw(spec: Draw, generator, device) -> torch.Tensor:
    """The draw ``spec`` from ``generator`` (a ``torch.Generator``, a
    ``parallel.draws.ShardedGenerator`` or None) on ``device``."""
    shape, dtype = tuple(spec.shape), spec.dtype
    if spec.kind == "gumbel":
        tiny = torch.finfo(dtype).tiny
        uniform = draws.rand(shape, generator, device=device, dtype=dtype)
        return -torch.log(-torch.log(uniform.clamp(min=tiny)))
    if spec.kind == "normal":
        return draws.randn(shape, generator, device=device, dtype=dtype)
    if spec.kind == "uniform":
        return draws.rand(shape, generator, device=device, dtype=dtype)
    if spec.kind == "randint":
        return draws.randint(0, spec.high, shape, generator, device=device,
                             dtype=dtype)
    raise ValueError(f"unknown draw kind {spec.kind!r}")


def _normal_noise(shape, like, generator, noise):
    if noise is not None:
        return noise.to(like.dtype)
    return draw(Draw("normal", shape, like.dtype), generator, like.device)


def _gumbel_noise(like, generator, noise):
    if noise is not None:
        return noise.to(like.dtype)
    return draw(Draw("gumbel", like.shape, like.dtype), generator,
                like.device)


class CategoricalDistribution(ParametricDistribution):
    """Single discrete action from logits (Gumbel-max sampling)."""

    def __init__(self, n_actions: int, dtype=torch.int32):
        super().__init__(param_size=n_actions, reparametrizable=False)
        self._dtype = dtype

    def sample(self, parameters, generator=None, noise=None):
        gumbel = _gumbel_noise(parameters, generator, noise)
        return torch.argmax(parameters + gumbel, dim=-1).to(self._dtype)

    def log_prob(self, parameters, actions):
        logp = F.log_softmax(parameters, dim=-1)
        return torch.gather(logp, -1, actions[..., None].long()).squeeze(-1)

    def entropy(self, parameters, generator=None, noise=None):
        logp = F.log_softmax(parameters, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)

    def kl_divergence(self, parameters_a, parameters_b):
        logp_a = F.log_softmax(parameters_a, dim=-1)
        logp_b = F.log_softmax(parameters_b, dim=-1)
        return torch.sum(torch.exp(logp_a) * (logp_a - logp_b), dim=-1)

    def mode(self, parameters):
        return torch.argmax(parameters, dim=-1).to(self._dtype)

    def draws(self, parameters):
        return Draw("gumbel", tuple(parameters.shape), parameters.dtype)


class MultiCategoricalDistribution(ParametricDistribution):
    """Independent categoricals over ``n_dimensions`` action dims."""

    def __init__(self, n_dimensions: int, n_actions_per_dim: int,
                 dtype=torch.int32):
        super().__init__(
            param_size=n_dimensions * n_actions_per_dim,
            reparametrizable=False,
        )
        self._n_dimensions = n_dimensions
        self._n_actions_per_dim = n_actions_per_dim
        self._dtype = dtype

    def _logits(self, parameters):
        return parameters.reshape(
            parameters.shape[:-1]
            + (self._n_dimensions, self._n_actions_per_dim)
        )

    def sample(self, parameters, generator=None, noise=None):
        logits = self._logits(parameters)
        gumbel = _gumbel_noise(logits, generator, noise)
        return torch.argmax(logits + gumbel, dim=-1).to(self._dtype)

    def log_prob(self, parameters, actions):
        logp = F.log_softmax(self._logits(parameters), dim=-1)
        per_dim = torch.gather(logp, -1, actions[..., None].long()).squeeze(-1)
        return torch.sum(per_dim, dim=-1)

    def entropy(self, parameters, generator=None, noise=None):
        logp = F.log_softmax(self._logits(parameters), dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=(-2, -1))

    def kl_divergence(self, parameters_a, parameters_b):
        logp_a = F.log_softmax(self._logits(parameters_a), dim=-1)
        logp_b = F.log_softmax(self._logits(parameters_b), dim=-1)
        return torch.sum(torch.exp(logp_a) * (logp_a - logp_b), dim=(-2, -1))

    def mode(self, parameters):
        return torch.argmax(self._logits(parameters), dim=-1).to(self._dtype)

    def draws(self, parameters):
        return Draw("gumbel", tuple(self._logits(parameters).shape),
                    parameters.dtype)


class _SafeExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        e = torch.exp(torch.clamp(x, -15.0, 15.0))
        ctx.save_for_backward(e)
        return e

    @staticmethod
    def backward(ctx, grad):
        (e,) = ctx.saved_tensors
        return grad * e


def safe_exp(x):
    """exp with clipped forward value but full-range gradient dy*exp(clip(x))."""
    return _SafeExp.apply(x)


def softplus_default_std_fn(scale):
    return F.softplus(scale) + 1e-3


def safe_exp_std_fn(std_for_zero_param: float, min_std: float):
    std_shift = math.log(std_for_zero_param - min_std)
    return lambda scale: safe_exp(scale + std_shift) + min_std


def _softplus_inverse(y: float) -> float:
    return math.log(math.expm1(y))


def softplus_std_fn(std_for_zero_param: float, min_std: float):
    std_shift = _softplus_inverse(std_for_zero_param - min_std)
    return lambda scale: F.softplus(scale + std_shift) + min_std


def _tanh_forward_log_det_jacobian(x):
    # log|d tanh(x)/dx| = log(1 - tanh(x)^2) = 2*(log 2 - x - softplus(-2x)).
    return 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))


def _atanh(y):
    return 0.5 * (torch.log1p(y) - torch.log1p(-y))


def _normal_log_pdf(x, loc, scale):
    # jax.scipy.stats.norm.logpdf, term for term.
    scale_sqrd = torch.square(scale)
    log_normalizer = torch.log(2.0 * math.pi * scale_sqrd)
    quadratic = torch.square(x - loc) / scale_sqrd
    return (log_normalizer + quadratic) / -2.0


def _normal_log_cdf(x, loc, scale):
    return torch.special.log_ndtr((x - loc) / scale)


class NormalTanhDistribution(ParametricDistribution):
    """Diagonal normal squashed by tanh; boundary-corrected log_prob.

    Outside ``[-threshold, threshold]`` the log_prob is the log *average*
    density of the corresponding tail, keeping it finite and differentiable
    w.r.t. the parameters.
    """

    def __init__(self, num_actions: int,
                 gaussian_std_fn: Callable = softplus_default_std_fn,
                 threshold: float = 0.999):
        super().__init__(param_size=2 * num_actions, reparametrizable=True)
        self._std_fn = gaussian_std_fn
        self._threshold = threshold

    def _loc_scale(self, parameters):
        loc, scale = torch.chunk(parameters, 2, dim=-1)
        return loc, self._std_fn(scale)

    def sample(self, parameters, generator=None, noise=None):
        loc, scale = self._loc_scale(parameters)
        eps = _normal_noise(loc.shape, loc, generator, noise)
        return torch.tanh(loc + scale * eps)

    def _per_dim_log_prob(self, loc, scale, event):
        threshold = self._threshold
        event = torch.clamp(event, -threshold, threshold)
        x = _atanh(event)
        in_log_prob = _normal_log_pdf(
            x, loc, scale
        ) - _tanh_forward_log_det_jacobian(x)

        # Computed in f32, as the JAX package does.
        inverse_threshold = _atanh(
            torch.tensor(threshold, dtype=loc.dtype, device=loc.device)
        )
        log_epsilon = math.log(1.0 - threshold)
        # log(average pdf) over the tail beyond the clipping threshold:
        # log P(X <= -t) resp. log P(X >= t), minus log(1 - threshold).
        log_prob_left = (
            _normal_log_cdf(-inverse_threshold, loc, scale) - log_epsilon
        )
        log_prob_right = (
            _normal_log_cdf(-inverse_threshold, -loc, scale) - log_epsilon
        )
        return torch.where(
            event <= -threshold,
            log_prob_left,
            torch.where(event >= threshold, log_prob_right, in_log_prob),
        )

    def log_prob(self, parameters, actions):
        loc, scale = self._loc_scale(parameters)
        return torch.sum(self._per_dim_log_prob(loc, scale, actions), dim=-1)

    def entropy(self, parameters, generator=None, noise=None):
        if generator is None and noise is None:
            raise ValueError(
                "NormalTanhDistribution entropy is a single-sample estimate "
                "and needs a generator or injected noise."
            )
        loc, scale = self._loc_scale(parameters)
        base_entropy = _HALF_LOG_2PI_E + torch.log(scale)
        x = loc + scale * _normal_noise(loc.shape, loc, generator, noise)
        return torch.sum(
            base_entropy + _tanh_forward_log_det_jacobian(x), dim=-1
        )

    def kl_divergence(self, parameters_a, parameters_b):
        # KL between the base normals (the tanh bijector cancels).
        loc_a, scale_a = self._loc_scale(parameters_a)
        loc_b, scale_b = self._loc_scale(parameters_b)
        return torch.sum(_normal_kl(loc_a, scale_a, loc_b, scale_b), dim=-1)

    def mode(self, parameters):
        loc, _ = self._loc_scale(parameters)
        return torch.tanh(loc)

    def draws(self, parameters):
        return _normal_draw(parameters)


def _normal_draw(parameters):
    """The standard normal noise of a diagonal normal's [..., 2 * A]
    parameters (loc and scale)."""
    shape = tuple(parameters.shape[:-1]) + (parameters.shape[-1] // 2,)
    return Draw("normal", shape, parameters.dtype)


def _normal_kl(loc_a, scale_a, loc_b, scale_b):
    var_ratio = torch.square(scale_a / scale_b)
    return 0.5 * (
        var_ratio
        + torch.square((loc_a - loc_b) / scale_b)
        - 1.0
        - torch.log(var_ratio)
    )


class NormalClippedDistribution(ParametricDistribution):
    """Diagonal normal whose *samples* are clipped to [-1, 1].

    The log_prob/entropy are those of the unclipped normal.
    """

    def __init__(self, num_actions: int,
                 gaussian_std_fn: Callable = softplus_default_std_fn):
        super().__init__(param_size=2 * num_actions, reparametrizable=True)
        self._std_fn = gaussian_std_fn

    def _loc_scale(self, parameters):
        loc, scale = torch.chunk(parameters, 2, dim=-1)
        return loc, self._std_fn(scale)

    def sample(self, parameters, generator=None, noise=None):
        loc, scale = self._loc_scale(parameters)
        eps = _normal_noise(loc.shape, loc, generator, noise)
        return torch.clamp(loc + scale * eps, -1.0, 1.0)

    def log_prob(self, parameters, actions):
        loc, scale = self._loc_scale(parameters)
        return torch.sum(_normal_log_pdf(actions, loc, scale), dim=-1)

    def entropy(self, parameters, generator=None, noise=None):
        _, scale = self._loc_scale(parameters)
        return torch.sum(_HALF_LOG_2PI_E + torch.log(scale), dim=-1)

    def kl_divergence(self, parameters_a, parameters_b):
        loc_a, scale_a = self._loc_scale(parameters_a)
        loc_b, scale_b = self._loc_scale(parameters_b)
        return torch.sum(_normal_kl(loc_a, scale_a, loc_b, scale_b), dim=-1)

    def mode(self, parameters):
        loc, _ = self._loc_scale(parameters)
        return torch.clamp(loc, -1.0, 1.0)

    def draws(self, parameters):
        return _normal_draw(parameters)


class DeterministicTanhDistribution(ParametricDistribution):
    """tanh(parameters); used for deterministic continuous policies."""

    def __init__(self, num_actions: int):
        super().__init__(param_size=num_actions, reparametrizable=True)

    def sample(self, parameters, generator=None, noise=None):
        return torch.tanh(parameters)

    def log_prob(self, parameters, actions):
        raise NotImplementedError(
            "Deterministic distribution has no density."
        )

    def entropy(self, parameters, generator=None, noise=None):
        return torch.zeros(
            parameters.shape[:-1], dtype=parameters.dtype,
            device=parameters.device,
        )

    def kl_divergence(self, parameters_a, parameters_b):
        raise NotImplementedError

    def mode(self, parameters):
        return torch.tanh(parameters)

    def draws(self, parameters):
        return None


class JointDistribution(ParametricDistribution):
    """Concatenation of independent sub-distributions (Tuple spaces).

    Actions are concatenated along the last axis in ``dtype_override``;
    discrete sub-actions occupy one slot each. ``noise``, where given, is a
    sequence with one entry (or None) per sub-distribution.
    """

    def __init__(self, distributions: Sequence[ParametricDistribution],
                 dtype_override=torch.float32):
        super().__init__(
            param_size=sum(d.param_size for d in distributions),
            reparametrizable=all(d.reparametrizable for d in distributions),
        )
        self._dists = list(distributions)
        self._dtype = dtype_override

    def _action_width(self, dist: ParametricDistribution) -> int:
        if isinstance(dist, CategoricalDistribution):
            return 1
        if isinstance(dist, MultiCategoricalDistribution):
            return dist._n_dimensions
        return dist.param_size // 2 if dist.reparametrizable else dist.param_size

    def _split_params(self, parameters):
        return torch.split(
            parameters, [d.param_size for d in self._dists], dim=-1
        )

    def _split_actions(self, actions):
        return torch.split(
            actions, [self._action_width(d) for d in self._dists], dim=-1
        )

    def _noises(self, noise):
        return [None] * len(self._dists) if noise is None else list(noise)

    def sample(self, parameters, generator=None, noise=None):
        samples = []
        for dist, params, n in zip(
            self._dists, self._split_params(parameters), self._noises(noise)
        ):
            s = dist.sample(params, generator, n)
            if s.dim() == params.dim() - 1:
                s = s[..., None]
            samples.append(s.to(self._dtype))
        return torch.cat(samples, dim=-1)

    def log_prob(self, parameters, actions):
        total = 0.0
        for dist, params, act in zip(
            self._dists,
            self._split_params(parameters),
            self._split_actions(actions),
        ):
            if isinstance(dist, CategoricalDistribution):
                act = act.squeeze(-1)
            total = total + dist.log_prob(params, act)
        return total

    def entropy(self, parameters, generator=None, noise=None):
        total = 0.0
        for dist, params, n in zip(
            self._dists, self._split_params(parameters), self._noises(noise)
        ):
            total = total + dist.entropy(params, generator, n)
        return total

    def kl_divergence(self, parameters_a, parameters_b):
        total = 0.0
        for dist, pa, pb in zip(
            self._dists,
            self._split_params(parameters_a),
            self._split_params(parameters_b),
        ):
            total = total + dist.kl_divergence(pa, pb)
        return total

    def mode(self, parameters):
        modes = []
        for dist, params in zip(self._dists, self._split_params(parameters)):
            m = dist.mode(params)
            if m.dim() == params.dim() - 1:
                m = m[..., None]
            modes.append(m.to(self._dtype))
        return torch.cat(modes, dim=-1)

    def draws(self, parameters):
        return [dist.draws(params) for dist, params in
                zip(self._dists, self._split_params(parameters))]


@dataclasses.dataclass
class ContinuousDistributionConfig:
    """Mirrors the reference's ContinuousDistributionConfig."""

    gaussian_std_fn: Callable = softplus_default_std_fn
    postprocessor: str = "Tanh"
    min_gaussian_std: float = 1e-3


def continuous_action_config(
    action_min_gaussian_std: float = 1e-3,
    action_gaussian_std_fn: str = "softplus",
    action_std_for_zero_param: float = 1.0,
    action_postprocessor: str = "Tanh",
) -> ContinuousDistributionConfig:
    config = ContinuousDistributionConfig()
    config.min_gaussian_std = float(action_min_gaussian_std)
    if action_gaussian_std_fn == "safe_exp":
        config.gaussian_std_fn = safe_exp_std_fn(
            action_std_for_zero_param, config.min_gaussian_std
        )
    elif action_gaussian_std_fn == "softplus":
        config.gaussian_std_fn = softplus_std_fn(
            action_std_for_zero_param, config.min_gaussian_std
        )
    else:
        raise ValueError(
            "action_gaussian_std_fn supports safe_exp and softplus, got: "
            f"{action_gaussian_std_fn}"
        )
    config.postprocessor = action_postprocessor
    return config


def get_parametric_distribution_for_action_space(
    action_space,
    continuous_config: Optional[ContinuousDistributionConfig] = None,
) -> ParametricDistribution:
    """Dispatch on a space's shape: Tuple / MultiDiscrete / Discrete / Box."""
    sub_spaces = getattr(action_space, "spaces", None)
    if isinstance(sub_spaces, (tuple, list)):
        return JointDistribution(
            [
                get_parametric_distribution_for_action_space(
                    sub, continuous_config
                )
                for sub in sub_spaces
            ]
        )
    if hasattr(action_space, "nvec"):
        nvec = [int(n) for n in action_space.nvec]
        if min(nvec) != max(nvec):
            raise ValueError(f"space nvec must be constant: {nvec}")
        return MultiCategoricalDistribution(len(nvec), nvec[0])
    if hasattr(action_space, "n"):
        return CategoricalDistribution(int(action_space.n))
    if hasattr(action_space, "low") and hasattr(action_space, "high"):
        if len(action_space.shape) != 1:
            raise ValueError(
                f"Box action spaces must be 1-D, got {action_space.shape}"
            )
        if any(float(l) != -1 for l in action_space.low) or any(
            float(h) != 1 for h in action_space.high
        ):
            raise ValueError(
                "Only actions bounded to [-1, 1] are supported; wrap the env "
                "with UniformBoundActionSpaceWrapper."
            )
        if continuous_config is None:
            continuous_config = ContinuousDistributionConfig()
        if continuous_config.postprocessor == "Tanh":
            return NormalTanhDistribution(
                action_space.shape[0],
                gaussian_std_fn=continuous_config.gaussian_std_fn,
            )
        if continuous_config.postprocessor == "ClippedIdentity":
            return NormalClippedDistribution(
                action_space.shape[0],
                gaussian_std_fn=continuous_config.gaussian_std_fn,
            )
        raise ValueError(
            f"Postprocessor {continuous_config.postprocessor} not supported."
        )
    raise ValueError(f"Unsupported action space {action_space}")
