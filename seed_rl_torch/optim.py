"""The optimizer of ``seed_rl_tpu/train.py``: global-norm clip, then Adam.

``ClippedAdam`` is ``optax.chain(optax.clip_by_global_norm(clip_norm),
optax.adam(schedule, b1=b1, eps=eps))`` over a list of parameters:
- the clip is written out because optax's has no epsilon, while
  ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm;
- ``torch.optim.Adam`` matches ``optax.adam`` (eps outside the square root);
- ``learning_rate`` is a float or, as optax takes it, a schedule
  ``count -> lr`` over optimizer updates (``linear_schedule`` and
  ``cosine_decay_schedule`` are optax's);
- a ``weight_decay`` makes it ``optax.adamw``: ``p - lr * (adam + wd * p)``,
  which is ``torch.optim.Adam``'s decoupled decay-then-step (with 0 Adam
  skips the decay);
- a parameter the loss did not reach steps with a zero gradient, as optax
  gives it one: its moments decay and it moves on them, where
  ``torch.optim.Adam`` would skip it and keep a step count of its own;
- under ``parallel.collectives.over(mesh)`` the gradients are averaged over
  the ranks (one all-reduce) before the clip, so the clip sees the global
  gradient, as the JAX learners' ``pmean`` gives it.

``state_dict`` / ``load_state_dict`` carry what optax's chain state
carries: each parameter's Adam moments and step, and ``count``, which is
also the schedule's position. A run restored from it steps on bitwise as
if never stopped.
"""

import math
from typing import Callable, Dict, Iterable, List, Optional, Union

import torch

from seed_rl_torch.parallel import collectives
from seed_rl_torch.utils.profiling import span


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all of ``grads`` together (optax ``global_norm``)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads])
    )


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scales ``grads`` in place by ``max_norm / norm`` where the global norm
    reaches ``max_norm`` (optax ``clip_by_global_norm``); returns the norm.

    The choice is made on the device, so the step waits for no host sync.
    """
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule``: from ``init_value`` to ``end_value`` over
    ``transition_steps`` updates, then flat (flat at ``init_value`` when
    ``transition_steps`` is not positive)."""
    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return init_value
        done = min(count, transition_steps) / transition_steps
        return (init_value - end_value) * (1.0 - done) + end_value

    return schedule


def cosine_decay_schedule(init_value: float,
                          decay_steps: int) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule`` (``alpha`` 0): ``init_value * (1 +
    cos(pi * min(count, decay_steps) / decay_steps)) / 2``."""
    def schedule(count: int) -> float:
        done = min(count, decay_steps) / decay_steps
        return init_value * 0.5 * (1.0 + math.cos(math.pi * done))

    return schedule


class ClippedAdam:
    """Global-norm clip + Adam (AdamW with a ``weight_decay``), at a fixed
    learning rate or on a schedule."""

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        learning_rate: Union[float, Callable[[int], float]],
        clip_norm: Optional[float] = None,
        b1: float = 0.9,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
    ):
        self.params = list(params)
        self.clip_norm = clip_norm
        self.schedule = learning_rate if callable(learning_rate) else (
            lambda count: learning_rate)
        self.count = 0  # optimizer updates applied, as optax counts them
        self._adam = torch.optim.Adam(
            self.params, lr=self.schedule(0), betas=(b1, 0.999), eps=eps,
            weight_decay=weight_decay, decoupled_weight_decay=True)

    def learning_rate(self) -> float:
        """The schedule at the current update count."""
        return self.schedule(self.count)

    def zero_grad(self):
        self._adam.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clips, applies Adam; returns the global gradient norm before the
        clip (what the JAX learners log as ``grad/norm``)."""
        with span("update.optimizer"):
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in self.params]
            mesh = collectives.active()
            if mesh is not None:
                mesh.average_(grads)
            if self.clip_norm is not None:
                norm = clip_by_global_norm_(grads, self.clip_norm)
            else:
                norm = global_norm(grads)
            for group in self._adam.param_groups:
                group["lr"] = self.learning_rate()
            self._adam.step()
            self.count += 1
            return norm

    def state_dict(self) -> Dict[str, object]:
        """``count`` and, per parameter in order, Adam's ``step``,
        ``exp_avg`` and ``exp_avg_sq`` (live tensors; zeros before the first
        update, when Adam holds none yet)."""
        moments = [self._adam.state.get(p) or {
            "step": torch.zeros(()), "exp_avg": torch.zeros_like(p),
            "exp_avg_sq": torch.zeros_like(p)} for p in self.params]
        return {"count": self.count, **{
            key: [m[key] for m in moments]
            for key in ("step", "exp_avg", "exp_avg_sq")}}

    def load_state_dict(self, state: Dict[str, object]):
        """Takes copies of ``state``'s tensors (Adam updates its own in
        place); a ``count`` of 0 leaves Adam to make its state at the first
        update, as a new optimizer does."""
        self.count = int(state["count"])
        self._adam.state.clear()
        if not self.count:
            return
        for i, p in enumerate(self.params):
            self._adam.state[p] = {
                "step": state["step"][i].detach().clone(),
                "exp_avg": state["exp_avg"][i].detach().to(p.device,
                                                           copy=True),
                "exp_avg_sq": state["exp_avg_sq"][i].detach().to(p.device,
                                                                 copy=True),
            }
