"""CUDA graphs as the port's learners drive them.

``RolloutEngine`` (``rollout.py``) captures its T env and policy steps,
``R2D2Update`` (``agents/r2d2.py``) one batch's forward and backward. Each
inherits ``GraphedCalls`` and hands it a body and a hand-out; every other
decision about a graphed body is made here. The helpers: ``signature``
(structure, shapes, dtypes, devices), ``tensors_of`` (every tensor an
object reads, by path) and ``out_of_memory``.
"""

import gc
import warnings
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.utils._pytree as pytree

from seed_rl_torch.utils.profiling import span


class CudaGraph:
    """``torch.cuda.CUDAGraph`` as the port's graphed bodies drive it.

    ``capture(fn)`` records ``fn``'s work on a side stream of ``device``
    with ``generators`` registered, and returns its outputs, which the
    graph's memory pool holds; a capture draws nothing. Each ``replay()``
    reruns the work on that device's current stream, drawing from each
    generator what the eager calls would draw next and advancing it as far.
    """

    def __init__(self, generators: Sequence[torch.Generator], device):
        self.device = torch.device(device)
        self._graph = torch.cuda.CUDAGraph()
        for generator in generators:
            self._graph.register_generator_state(generator)

    def capture(self, fn):
        # ``torch.cuda.graph`` empties the cache for the graph's pool; the
        # memory of dead objects in reference cycles (a learner
        # ``train.main`` built is one) only a collection frees.
        gc.collect()
        # A stream of this device's own, and "thread_local": another
        # thread's CUDA calls (a logger's copies) do not end the capture.
        with torch.cuda.device(self.device), torch.cuda.graph(
                self._graph, stream=torch.cuda.Stream(),
                capture_error_mode="thread_local"):
            return fn()

    def replay(self):
        with torch.cuda.device(self.device):
            self._graph.replay()


class Captured:
    """A body of device work captured once, over static inputs.

    ``inputs`` are cloned into the static inputs (``self.inputs``), which
    the capture reads; ``watched``, the tensors the body reads in place by
    path, are kept, since the graph reads their memory: a tensor written
    in place (a parameter Adam steps) reaches the next replay as it is.
    ``fits`` tells whether a replay computes the body on other inputs and
    the watched tensors as they are now: the same signatures, and each
    watched tensor the one captured or rebound to one whose values can be
    copied into it. A call copies those values and then the inputs in,
    replays under ``replay_span`` and returns the static outputs.
    """

    def __init__(self, graph, body, inputs, watched, replay_span: str):
        self._graph = graph
        self.inputs = pytree.tree_map(torch.clone, inputs)
        self._input_leaves = pytree.tree_leaves(self.inputs)
        self._signature = signature(inputs)
        self._watched = dict(watched)
        self._watched_signature = signature(watched)
        self._replay_span = replay_span
        self._outputs = graph.capture(lambda: body(self.inputs))

    def fits(self, inputs, watched) -> bool:
        return (signature(inputs) == self._signature
                and signature(watched) == self._watched_signature
                and self._rebound_fit(watched))

    def _rebound_fit(self, watched) -> bool:
        """Whether each watched tensor rebound since the capture (the
        normalizer's ``obs_norm``, a net loaded by assignment) can have its
        values copied into the captured one."""
        live = {t.data_ptr() for t in watched.values()}
        writes = {}
        for path, tensor in watched.items():
            captured = self._watched[path]
            if tensor.data_ptr() == captured.data_ptr():
                continue
            # A value read on the host is part of the graph; a captured
            # tensor still in use, or captured at two paths that now hold
            # two tensors, cannot take the new values.
            if (captured.device != self._graph.device
                    or captured.data_ptr() in live
                    or writes.setdefault(captured.data_ptr(),
                                         tensor.data_ptr())
                    != tensor.data_ptr()):
                return False
        return True

    def __call__(self, inputs, watched):
        for path, tensor in watched.items():
            captured = self._watched[path]
            if tensor.data_ptr() != captured.data_ptr():
                captured.copy_(tensor)
        for static, given in zip(self._input_leaves,
                                 pytree.tree_leaves(inputs)):
            if given is not static:
                static.copy_(given)
        with span(self._replay_span):
            self._graph.replay()
        return self._outputs


class GraphedCalls:
    """The steps from an eager body to a replayed graph, for the class that
    inherits them.

    ``_init_graphs`` takes the device (a graph only on a CUDA one), the
    prefix of the spans and what the body is, for the warning.
    ``_through_graph(body, inputs, watched, generators, hand_out)`` returns
    ``body(inputs)`` on the first call at the body's shapes; on the second
    it captures the body (a ``Captured`` over
    ``graph_class(generators, device)``, under ``<prefix>.capture``), and
    from then on it replays and returns ``hand_out(outputs,
    static_inputs)``. A held graph that does not fit ``inputs`` and
    ``watched`` is dropped, and the next call runs eagerly again. A
    capture that CUDA refuses (a body that waits for the host, for one)
    leaves the body eager for good, with one warning; running out of
    memory is no refusal and raises. ``captures``, ``graph_replays`` and
    ``capture_failures`` count the events.
    """

    def _init_graphs(self, device: torch.device, prefix: str, what: str):
        self._graph_class = CudaGraph if device.type == "cuda" else None
        self._graph_device = device
        self._graph: Optional[Captured] = None
        self._warm = False  # an eager call has run with no graph held
        self._graph_prefix = prefix
        self._graph_what = what
        self.captures = 0
        self.graph_replays = 0
        self.capture_failures = 0

    def _through_graph(self, body: Callable, inputs,
                       watched: Dict[tuple, torch.Tensor],
                       generators: Sequence[torch.Generator],
                       hand_out: Callable):
        graph = self._graph
        if graph is not None and not graph.fits(inputs, watched):
            graph = self._graph = None
            self._warm = False
        if graph is None:
            if not self._warm:
                self._warm = True
                return body(inputs)
            graph = self._capture(body, inputs, watched, generators)
            if graph is None:
                return body(inputs)
        self.graph_replays += 1
        return hand_out(graph(inputs, watched), graph.inputs)

    def _capture(self, body, inputs, watched,
                 generators) -> Optional[Captured]:
        with span(f"{self._graph_prefix}.capture"):
            try:
                graph = Captured(
                    self._graph_class(generators, self._graph_device),
                    body, inputs, watched,
                    f"{self._graph_prefix}.graph_replay")
            except RuntimeError as e:
                if out_of_memory(e):
                    raise
                self._graph_class = None
                self.capture_failures += 1
                warnings.warn(
                    f"{self._graph_what} could not be captured as a CUDA "
                    f"graph and runs eagerly from now on: {e}",
                    RuntimeWarning)
                return None
        self.captures += 1
        self._graph = graph
        return graph



def out_of_memory(error: BaseException) -> bool:
    """Whether ``error``, or an error it was raised in handling, is the
    card running out of memory (the allocator's ``OutOfMemoryError``, or
    CUDA's own "out of memory" error)."""
    while error is not None:
        if (isinstance(error, torch.OutOfMemoryError)
                or "out of memory" in str(error)):
            return True
        error = error.__cause__ or error.__context__
    return False


def signature(tree):
    """The tree's structure and each leaf's shape, dtype and device."""
    leaves, spec = pytree.tree_flatten(tree)
    return spec, [(t.shape, t.dtype, t.device) for t in leaves]


def tensors_of(root) -> Dict[tuple, torch.Tensor]:
    """The non-empty tensors reachable from ``root``, by path: through
    lists, tuples and dicts, a module's parameters, buffers and submodules
    (and a port module's public attributes), and the attributes of the
    port's other objects."""
    found: Dict[tuple, torch.Tensor] = {}
    seen = set()

    def walk(obj, path):
        if isinstance(obj, torch.nn.Module):
            items = [*obj._parameters.items(), *obj._buffers.items(),
                     *obj._modules.items()]
            if _ours(obj):
                items += [(k, v) for k, v in vars(obj).items()
                          if not k.startswith("_")]
        elif isinstance(obj, (list, tuple)):
            items = enumerate(obj)
        elif isinstance(obj, dict):
            items = obj.items()
        else:
            items = getattr(obj, "__dict__", {}).items()
        for key, value in items:
            if isinstance(value, torch.Tensor):
                if value.numel():
                    found[path + (key,)] = value
            elif id(value) not in seen and (
                    isinstance(value, (list, tuple, dict, torch.nn.Module))
                    or _ours(value)):
                seen.add(id(value))
                walk(value, path + (key,))

    walk(root, ())
    return found


def _ours(obj) -> bool:
    return type(obj).__module__.startswith("seed_rl_torch.")
