"""Stand-ins for ``seed_rl_torch.cuda_graph.CudaGraph`` on the CPU, built
as the seam builds a graph class: ``graph_class(generators, device)``.

``DirectCall``'s capture runs the body once and puts the generators back,
as a capture draws nothing; its replay runs the body again on the static
inputs and writes the results into the captured outputs. A graph's replay
runs no Python, so the stand-in's replay opens no span and leaves each of
``params``' ``.grad`` as it was. ``Refusing`` raises in its capture, as
CUDA does for a body that syncs with the host; ``OutOfMemory`` runs out of
the card's memory in its capture.
"""

import functools

import torch.utils._pytree as pytree

from seed_rl_torch.utils import profiling


class DirectCall:

    def __init__(self, generators, device, params=()):
        self.generators = generators
        self.device = device
        self.params = params

    def capture(self, fn):
        states = [g.get_state() for g in self.generators]
        self.fn = fn
        self.outputs = fn()
        for generator, state in zip(self.generators, states):
            generator.set_state(state)
        return self.outputs

    def replay(self):
        recording, profiling._recording = profiling._recording, False
        grads = [p.grad for p in self.params]
        try:
            outputs = self.fn()
        finally:
            profiling._recording = recording
            for p, grad in zip(self.params, grads):
                p.grad = grad
        for static, new in zip(pytree.tree_leaves(self.outputs),
                               pytree.tree_leaves(outputs)):
            static.copy_(new)


class Refusing(DirectCall):

    def capture(self, fn):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")


class OutOfMemory(DirectCall):
    """``error`` is the allocator's, or CUDA's own, raised while the
    capture ends."""

    def __init__(self, generators, device, error, params=()):
        super().__init__(generators, device, params)
        self.error = error

    def capture(self, fn):
        try:
            raise self.error
        finally:
            raise RuntimeError("CUDA error: operation failed due to a "
                               "previous error during capture")


def graphed(owner, graph_class=DirectCall, **kwargs):
    """``owner`` (a ``GraphedCalls``) on the CPU through ``graph_class``,
    built with ``kwargs`` besides the seam's arguments."""
    owner._graph_class = functools.partial(graph_class, **kwargs)
    return owner
