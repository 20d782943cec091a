"""Batch reductions over the whole mesh: the losses' and statistics' means,
sums, standard deviations, k-th values and log-sum-exps.

The JAX package runs one global-array program, so a ``jnp.mean`` over a
sharded batch is already the global mean. Here each rank holds its share,
and every reduction over the batch has to be made global by hand. The
learners' code calls these functions in place of ``torch.mean`` and its
kin; inside ``over(mesh)`` (which ``DistributedLearner`` enters around
every call it forwards) they reduce over every rank, and outside it they
are the plain torch functions, so a single-device learner runs exactly as
before.

The differentiable ones reduce through ``Mesh.sum``, whose backward
all-reduces the gradient: each rank's loss then holds the global value, its
gradient the rank's share times the world size, and the gradient average
before the optimizer step (``optim.ClippedAdam``) gives the global
gradient, as the JAX package's ``pmean`` does. Terms of replicated
parameters alone (an entropy-cost or temperature adjustment) come out
right by the same average.
"""

import builtins
import contextlib
import contextvars
import math

from typing import Dict

import torch

# The mesh the running call reduces over, or None: scoped by ``over`` like
# ``torch.no_grad``, and per thread (a context variable), so that a thread
# of the remote runtime never reduces over another's mesh.
_ACTIVE = contextvars.ContextVar("seed_rl_torch_mesh", default=None)


@contextlib.contextmanager
def over(mesh):
    """Reduce over ``mesh`` inside the block (no-op for None or a mesh
    whose collectives are off)."""
    token = _ACTIVE.set(
        mesh if mesh is not None and mesh.collective else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active():
    """The mesh reductions run over, or None."""
    return _ACTIVE.get()


def _dims(x, dim):
    if dim is None:
        return tuple(range(x.dim()))
    return (dim,) if isinstance(dim, int) else tuple(dim)


def _sum_and_count(x, dim, keepdim):
    mesh = _ACTIVE.get()
    dims = _dims(x, dim)
    local = torch.sum(x, dim=dims, keepdim=keepdim)
    count = math.prod(x.shape[d] for d in dims)
    packed = torch.cat([local.reshape(-1), torch.full(
        (1,), float(count), dtype=local.dtype, device=local.device)])
    packed = mesh.sum(packed)
    return packed[:-1].reshape(local.shape), packed[-1]


def mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """``torch.mean`` over every rank's ``x`` (shares may differ in size)."""
    mesh = _ACTIVE.get()
    if mesh is None:
        if dim is None:
            return torch.mean(x)
        return torch.mean(x, dim=dim, keepdim=keepdim)
    total, count = _sum_and_count(x, dim, keepdim)
    return total / count


def means(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``mean`` of each tensor of ``named`` (logged values, not
    differentiated), over every rank in one all-reduce."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return {k: torch.mean(v) for k, v in named.items()}
    values = [v.detach() for v in named.values()]
    packed = mesh.sum(torch.cat(
        [torch.stack([torch.sum(v) for v in values]),
         torch.tensor([float(v.numel()) for v in values],
                      device=values[0].device)]))
    totals, counts = packed[:len(values)], packed[len(values):]
    return dict(zip(named, totals / counts))


def sum(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:  # noqa: A001
    """``torch.sum`` over every rank's ``x``."""
    mesh = _ACTIVE.get()
    if mesh is None:
        if dim is None:
            return torch.sum(x)
        return torch.sum(x, dim=dim, keepdim=keepdim)
    return mesh.sum(torch.sum(x, dim=_dims(x, dim), keepdim=keepdim))


def count(x: torch.Tensor, dim=None) -> int:
    """The global number of elements ``mean`` divides by (a host int)."""
    mesh = _ACTIVE.get()
    local = math.prod(x.shape[d] for d in _dims(x, dim))
    if mesh is None:
        return local
    return builtins.sum(mesh.all_gather_counts(local))


def std(x: torch.Tensor, correction: int = 0) -> torch.Tensor:
    """The standard deviation of every rank's ``x`` together (all
    elements)."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return torch.std(x, correction=correction)
    centred = x - mean(x)
    total, n = _sum_and_count(torch.square(centred), None, False)
    return torch.sqrt(total / (n - correction))


def kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest of every rank's elements together (not
    differentiable)."""
    mesh = _ACTIVE.get()
    flat = x.reshape(-1)
    if mesh is not None:
        flat = mesh.all_gather(flat)
    return torch.min(torch.topk(flat, k).values)


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``log(sum(exp(x)))`` over every rank's elements together."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return torch.logsumexp(x.reshape(-1), dim=0)
    m = mesh.max(torch.max(x.detach()) if x.numel() else torch.full(
        (), -math.inf, dtype=x.dtype, device=x.device))
    return m + torch.log(mesh.sum(torch.sum(torch.exp(x - m))))


def softmax_all(x: torch.Tensor) -> torch.Tensor:
    """The softmax over every rank's elements together, this rank's
    part."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return torch.softmax(x.reshape(-1), dim=0).reshape(x.shape)
    return torch.exp(x - logsumexp(x))

