"""Batching inference front-end for external (host-process) actors.

Port of ``seed_rl_tpu/runtime/inference_server.py``, the replacement for
the reference's gRPC streaming inference server (grpc/ops/grpc.cc +
common/actor.py): env threads (in this process, or in actor processes
behind the socket transport) call ``inference(env_id, request) -> result``
once per step; the native C++ batcher (``seed_rl_torch/csrc/batcher.cc``)
groups the calls into batches; a runner thread runs the policy on each
batch (round-robin across the bound handlers, one per inference shard) and
the results are sliced back to the callers.

Wire format: each request and result is a fixed-size byte blob, the
concatenation of the leaves of its spec tree (``specs.ArraySpec`` leaves)
in ``jax.tree`` order, as in the JAX package: the same values give the
same bytes.

``batcher.cc`` is host code: it is built with g++ at first use into
``build/batcher/`` at the root of the checkout (a directory ``.gitignore``
lists; ``SEED_RL_TORCH_BUILD_DIR`` moves it, see
``utils/compilation_cache.py``), as ``ops/cuda/build.py`` builds the CUDA
kernels. A failed build
raises; there is no Python batcher to fall back to.
"""

import ctypes
import hashlib
import os
import pathlib
import pickle
import subprocess
import threading
import traceback
from typing import Callable, Sequence

import numpy as np

from seed_rl_torch.runtime import specs as specs_lib
from seed_rl_torch.utils import compilation_cache

_PACKAGE = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PACKAGE / "csrc" / "batcher.cc"
# The default build directory; ``SEED_RL_TORCH_BUILD_DIR`` moves it.
BUILD_DIR = compilation_cache.DEFAULT_DIR / "batcher"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LIB = None
_LIB_LOCK = threading.Lock()


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return compilation_cache.build_dir("batcher") / f"libbatcher-{digest}.so"


def build() -> pathlib.Path:
    """Compiles ``batcher.cc`` unless this source is built already."""
    target = library_path()
    if target.exists():
        return target
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    result = subprocess.run(
        ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if result.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{result.stdout}")
    os.replace(tmp, target)  # atomic: a reader never sees half a file
    return target


def _build_and_load():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        lib.batcher_create.restype = ctypes.c_void_p
        lib.batcher_create.argtypes = [ctypes.c_size_t] * 4
        lib.batcher_destroy.argtypes = [ctypes.c_void_p]
        lib.batcher_submit.restype = ctypes.c_int
        lib.batcher_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_char_p,
        ]
        lib.batcher_get_batch.restype = ctypes.c_int
        lib.batcher_get_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int,
        ]
        lib.batcher_complete_batch.restype = ctypes.c_int
        lib.batcher_complete_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_size_t,
        ]
        lib.batcher_fail_batch.restype = ctypes.c_int
        lib.batcher_fail_batch.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.batcher_shutdown.argtypes = [ctypes.c_void_p]
        lib.batcher_test_hold.restype = ctypes.c_int
        lib.batcher_test_hold.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
        lib.batcher_total_requests.restype = ctypes.c_uint64
        lib.batcher_total_requests.argtypes = [ctypes.c_void_p]
        lib.batcher_total_batches.restype = ctypes.c_uint64
        lib.batcher_total_batches.argtypes = [ctypes.c_void_p]
        lib.transport_server_create.restype = ctypes.c_void_p
        lib.transport_server_create.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_size_t,
        ]
        lib.transport_server_connections.restype = ctypes.c_uint64
        lib.transport_server_connections.argtypes = [ctypes.c_void_p]
        lib.transport_server_port.restype = ctypes.c_int
        lib.transport_server_port.argtypes = [ctypes.c_void_p]
        lib.transport_server_shutdown.argtypes = [ctypes.c_void_p]
        lib.transport_server_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class _Codec:
    """Flat fixed-size byte codec for a tree of ``ArraySpec`` leaves."""

    def __init__(self, specs):
        self.leaves, self.structure = specs_lib.flatten(specs)
        self.sizes = [
            int(np.prod(s.shape, dtype=np.int64)) * np.dtype(s.dtype).itemsize
            for s in self.leaves
        ]
        self.nbytes = int(sum(self.sizes))

    def _leaves(self, values):
        leaves = specs_lib.leaves_of(values)
        if len(leaves) != len(self.leaves):
            raise ValueError(f"{len(leaves)} leaves for a spec of "
                             f"{len(self.leaves)}")
        return leaves

    def encode(self, values) -> bytes:
        parts = []
        for leaf, spec in zip(self._leaves(values), self.leaves):
            arr = np.asarray(leaf, np.dtype(spec.dtype))
            if arr.shape != tuple(spec.shape):
                raise ValueError(f"a leaf of shape {arr.shape} for the spec "
                                 f"{spec}")
            parts.append(arr.tobytes())
        return b"".join(parts)

    def decode_batch(self, buf, count: int):
        """Bytes [count * nbytes] -> tree of [count, ...] numpy arrays."""
        raw = np.frombuffer(buf, np.uint8, count * self.nbytes).reshape(
            count, self.nbytes)
        out, offset = [], 0
        for spec, size in zip(self.leaves, self.sizes):
            chunk = raw[:, offset:offset + size]
            out.append(np.ascontiguousarray(chunk)
                       .view(np.dtype(spec.dtype))
                       .reshape((count,) + tuple(spec.shape)))
            offset += size
        return specs_lib.unflatten(self.structure, out)

    def decode(self, buf):
        """One blob -> the un-batched tree."""
        return specs_lib.map_tree(lambda x: x[0], self.decode_batch(buf, 1))

    def encode_batch(self, values) -> bytes:
        leaves = self._leaves(values)
        count = np.shape(leaves[0])[0]
        rows = []
        for leaf, spec in zip(leaves, self.leaves):
            arr = np.ascontiguousarray(np.asarray(leaf, np.dtype(spec.dtype))
                                       .reshape(count, -1))
            rows.append(arr.view(np.uint8).reshape(count, -1))
        return np.concatenate(rows, axis=1).tobytes()


class InferenceServer:
    """Dynamic-batching inference server driving policy handlers.

    Args:
      handlers: one callable per inference shard: ``handler(env_ids
        i64[count], batched_request_tree) -> batched result tree``, called
        round-robin per batch on the server's runner thread.
      request_specs / result_specs: trees of ``ArraySpec`` for a SINGLE
        request / result (no batch dim).
      batch_size: dynamic batch size (reference: inference_batch_size).
      num_buffers: in-flight batch buffers (2 = double buffering).
      flush_timeout_ms: fire partial batches after this idle time; -1 to
        fire only full batches (reference behaviour).
    """

    def __init__(
        self,
        handlers: Sequence[Callable],
        request_specs,
        result_specs,
        batch_size: int,
        num_buffers: int = 2,
        flush_timeout_ms: int = 50,
    ):
        if not handlers:
            raise ValueError("an InferenceServer needs a handler")
        self._lib = _build_and_load()
        self._handlers = list(handlers)
        self._request_specs = request_specs
        self._result_specs = result_specs
        self._req_codec = _Codec(request_specs)
        self._res_codec = _Codec(result_specs)
        self._transport = None
        self.batch_size = batch_size
        self._flush_timeout_ms = flush_timeout_ms
        self._handle = self._lib.batcher_create(
            batch_size, self._req_codec.nbytes, self._res_codec.nbytes,
            num_buffers)
        if not self._handle:
            raise ValueError(f"batcher_create refused batch_size={batch_size}"
                             f", num_buffers={num_buffers}")
        self._handler_error = None  # the last handler exception, as text
        self._stopped = threading.Event()
        self._runner = threading.Thread(target=self._run, daemon=True)
        self._runner.start()

    def _run(self):
        lib = self._lib
        shard = 0
        data_p = ctypes.c_char_p()
        ids_p = ctypes.POINTER(ctypes.c_int64)()
        count = ctypes.c_size_t()
        ticket = ctypes.c_uint64()
        while True:
            rc = lib.batcher_get_batch(
                self._handle, ctypes.byref(data_p), ctypes.byref(ids_p),
                ctypes.byref(count), ctypes.byref(ticket),
                self._flush_timeout_ms)
            if rc == 1:
                return  # shutdown
            if rc == 2:
                continue  # timeout, nothing to do
            n = count.value
            buf = ctypes.string_at(data_p, n * self._req_codec.nbytes)
            env_ids = np.ctypeslib.as_array(ids_p, shape=(n,)).copy()
            requests = self._req_codec.decode_batch(buf, n)
            handler = self._handlers[shard]
            shard = (shard + 1) % len(self._handlers)
            try:
                encoded = self._res_codec.encode_batch(
                    handler(env_ids, requests))
            except Exception as exc:
                # The runner stays alive (a dead runner deadlocks every
                # blocked submitter) and fails the batch, so every blocked
                # inference() call raises: the reference's server
                # cancellation on handler errors (grpc.cc:381-397).
                self._handler_error = "".join(
                    traceback.format_exception_only(type(exc), exc)).strip()
                traceback.print_exc()
                lib.batcher_fail_batch(self._handle, ticket.value)
                continue
            lib.batcher_complete_batch(self._handle, ticket.value, encoded, n)

    def inference(self, env_id: int, request):
        """Blocking per-step call from an actor thread."""
        req = self._req_codec.encode(request)
        out = ctypes.create_string_buffer(self._res_codec.nbytes)
        rc = self._lib.batcher_submit(self._handle, env_id, req, out)
        if rc == 2:
            raise RuntimeError("inference handler failed: "
                               f"{self._handler_error or 'unknown error'}")
        if rc != 0:
            raise RuntimeError("inference server is shut down")
        return self._res_codec.decode(out.raw)

    def serve(self, address: str, config=None) -> None:
        """Open the native socket front-end at ``address``.

        ``address`` is a unix-domain socket path (at most 107 bytes), or
        ``host:port`` / ``tcp://host:port`` for cross-machine fleets (port 0
        binds an ephemeral port: read it from ``bound_port``). Actor
        processes connect with ``transport.SocketClient`` or
        ``RemoteActorClient``; their calls go through the same batcher as
        in-process ``inference()`` calls. The handshake carries the request
        and result specs (the reference's Init RPC signature discovery,
        grpc.cc:145-153) and the learner's ``config`` (reference
        serialize_config / update_config, common/utils.py:1074-1110).
        """
        if self._transport is not None:
            raise RuntimeError("transport already started")
        blob = pickle.dumps(
            (self._request_specs, self._result_specs, config))
        self._transport = self._lib.transport_server_create(
            self._handle, address.encode(), blob, len(blob))
        if not self._transport:
            raise OSError(f"failed to bind the transport socket at {address}")

    @property
    def bound_port(self) -> int:
        """Bound TCP port (0 for unix-domain transports / no transport)."""
        if not self._transport:
            return 0
        return self._lib.transport_server_port(self._transport)

    @property
    def stats(self):
        stats = {
            "total_requests": self._lib.batcher_total_requests(self._handle),
            "total_batches": self._lib.batcher_total_batches(self._handle),
        }
        if self._transport:
            stats["connections"] = self._lib.transport_server_connections(
                self._transport)
        return stats

    def shutdown(self):
        if not self._stopped.is_set():
            self._stopped.set()
            self._lib.batcher_shutdown(self._handle)
            if self._transport:
                self._lib.transport_server_shutdown(self._transport)
                self._lib.transport_server_destroy(self._transport)
                self._transport = None
            self._runner.join(timeout=5)
