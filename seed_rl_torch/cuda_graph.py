"""CUDA graphs as the port's learners drive them.

``CudaGraph`` captures one body of device work and replays it;
``RolloutEngine`` (``rollout.py``) captures its T env and policy steps,
``R2D2Update`` (``agents/r2d2.py``) one batch's forward and backward.
Both inherit ``GraphedCalls``, the steps from eager to replayed: the first
call at the body's shapes runs it eagerly (which warms cuDNN, lazy inits
and the allocator), the second captures it and every call replays it.
``Captured`` is one capture over static inputs. The helpers tell whether
a capture still computes what the caller's tensors would: ``signature``
(structure, shapes, dtypes, devices) and ``tensors_of`` (every tensor an
object reads, by path), and whether a failed capture ran out of memory
(``out_of_memory``), which no caller takes for a refusal.
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
    (by default the generators') with ``generators`` registered, and
    returns its outputs, which the graph's memory pool holds; a capture
    draws nothing. Each ``replay()`` reruns the work on that device's
    current stream, drawing from each generator what the eager calls would
    draw next and advancing it as far.
    """

    def __init__(self, generators: Sequence[torch.Generator] = (),
                 device=None):
        self._device = (generators[0].device if device is None
                        else torch.device(device))
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
        with torch.cuda.device(self._device), torch.cuda.graph(
                self._graph, stream=torch.cuda.Stream(),
                capture_error_mode="thread_local"):
            return fn()

    def replay(self):
        with torch.cuda.device(self._device):
            self._graph.replay()


class Captured:
    """A body of device work captured once, over static inputs.

    ``inputs`` are cloned into the static inputs, which the capture reads
    (``body(self._inputs)``); ``watched``, the tensors the body reads in
    place by path, are kept, since the graph reads their memory. ``fits``
    tells whether a replay computes the body on other inputs and the
    watched tensors as they are now: the same signatures, and
    (``_watched_fit``, by default) each watched tensor the one captured.
    ``_copy_in`` copies a call's inputs into the static ones.
    """

    def __init__(self, graph, body, inputs, watched):
        self._graph = graph
        self._inputs = pytree.tree_map(torch.clone, inputs)
        self._input_leaves = pytree.tree_leaves(self._inputs)
        self._signature = signature(inputs)
        self._watched = dict(watched)
        self._watched_signature = signature(watched)
        self._outputs = graph.capture(lambda: body(self._inputs))

    def fits(self, inputs, watched) -> bool:
        return (signature(inputs) == self._signature
                and signature(watched) == self._watched_signature
                and self._watched_fit(watched))

    def _watched_fit(self, watched) -> bool:
        return all(t.data_ptr() == self._watched[path].data_ptr()
                   for path, t in watched.items())

    def _copy_in(self, inputs):
        for static, given in zip(self._input_leaves,
                                 pytree.tree_leaves(inputs)):
            if given is not static:
                static.copy_(given)


class GraphedCalls:
    """The steps from an eager body to a replayed graph, for the class that
    inherits them.

    ``_init_graphs`` takes the device (a graph only on a CUDA one), the
    prefix of the spans and what the body is, for the warning.
    ``_through_graph(eager, capture, inputs, watched)`` runs ``eager()`` on
    the first call at the body's shapes, captures the body on the second
    (``capture(graph_class)`` returns a ``Captured``, under
    ``<prefix>.capture``) and replays it from then on (``graph(inputs,
    watched)``); a held graph that does not fit ``inputs`` and ``watched``
    is dropped, and the next call runs eagerly again. A capture that CUDA
    refuses (a body that waits for the host, for one) leaves the body
    eager for good, with one warning; running out of memory is no refusal
    and raises. ``captures``, ``graph_replays`` and ``capture_failures``
    count the events.
    """

    def _init_graphs(self, device: torch.device, prefix: str, what: str):
        self._graph_class = CudaGraph if device.type == "cuda" else None
        self._graph: Optional[Captured] = None
        self._warm = False  # an eager call has run with no graph held
        self._graph_prefix = prefix
        self._graph_what = what
        self.captures = 0
        self.graph_replays = 0
        self.capture_failures = 0

    def _through_graph(self, eager: Callable, capture: Callable, inputs,
                       watched):
        graph = self._graph
        if graph is not None and not graph.fits(inputs, watched):
            graph = self._graph = None
            self._warm = False
        if graph is None:
            if not self._warm:
                self._warm = True
                return eager()
            graph = self._capture(capture)
            if graph is None:
                return eager()
        self.graph_replays += 1
        return graph(inputs, watched)

    def _capture(self, capture: Callable) -> Optional[Captured]:
        with span(f"{self._graph_prefix}.capture"):
            try:
                graph = capture(self._graph_class)
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
