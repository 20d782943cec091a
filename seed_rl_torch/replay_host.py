"""Prioritized replay in host RAM, at the reference's scale.

Port of ``seed_rl_tpu/replay_host.py``. The reference keeps its R2D2
replay in the learner's host RAM: 100k unrolls of 120 84x84 uint8 frames
are > 85 GB, beyond any device's memory. ``replay.PrioritizedReplay``
keeps a buffer on the device; this one is the host-RAM backend:
- storage is one preallocated numpy array ``[size, ...]`` per leaf of the
  item structure; uint8 frames stay uint8;
- FIFO wrap-around insertion, and ``priority ** exponent`` categorical
  sampling with max-normalized importance weights, drawn with
  ``np.random.default_rng(seed)`` from float64 priorities by a cumsum and
  ``searchsorted``: the same seed and priorities give the JAX package's
  indices and weights exactly;
- sampled batches are gathered on the host and copied to the device; a
  one-deep prefetch thread (``sample_async`` / ``wait_sample``) overlaps
  the gather and copy of batch k+1 with training on batch k. On the card
  the copy runs on the thread's own CUDA stream, which the thread waits
  for before it hands the batch over;
- ``update_priorities`` takes the priorities of the batch just trained.

Thread contract: every mutating call comes from one thread, the loop's; the
prefetch thread only reads, under the lock.

``save`` / ``restore`` persist the buffer in the port's own format: one
``.npy`` file per leaf (the filled rows only: rows never written are
zeros, and restore makes them so again), ``priorities.npy`` and a JSON
file with the cursors and a description of the item structure. The JAX
package pickles a jax treedef instead; the port neither writes nor reads
that format.
"""

import importlib
import json
import os
import shutil
import threading
from typing import Tuple

import numpy as np
import torch

from seed_rl_torch.device import resolve_device


def _describe(tree, leaves: list):
    """A JSON-able description of ``tree``'s structure; appends its leaves
    to ``leaves`` (dicts in sorted key order)."""
    if tree is None:
        return {"none": True}
    if isinstance(tree, dict):
        return {"dict": {k: _describe(tree[k], leaves) for k in sorted(tree)}}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = type(tree)
        return {"namedtuple": f"{cls.__module__}:{cls.__qualname__}",
                "fields": [_describe(x, leaves) for x in tree]}
    if isinstance(tree, (tuple, list)):
        return {type(tree).__name__: [_describe(x, leaves) for x in tree]}
    leaves.append(tree)
    return {"leaf": len(leaves) - 1}


def _namedtuple_class(name: str):
    module, _, qualname = name.partition(":")
    if not module.startswith("seed_rl_torch."):
        raise ValueError(f"replay snapshot names a foreign type {name!r}")
    return getattr(importlib.import_module(module), qualname)


def _rebuild(desc, leaves):
    """The inverse of ``_describe``."""
    if "none" in desc:
        return None
    if "leaf" in desc:
        return leaves[desc["leaf"]]
    if "dict" in desc:
        return {k: _rebuild(v, leaves) for k, v in desc["dict"].items()}
    if "namedtuple" in desc:
        cls = _namedtuple_class(desc["namedtuple"])
        return cls(*(_rebuild(x, leaves) for x in desc["fields"]))
    kind = "tuple" if "tuple" in desc else "list"
    return (tuple if kind == "tuple" else list)(
        _rebuild(x, leaves) for x in desc[kind])


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class HostReplayBuffer:
    """Prioritized FIFO replay in host RAM with device-bound sampling.

    Args:
      size: items the buffer holds.
      importance_sampling_exponent: beta of the importance weights.
      seed: seeds the numpy generator of the draws.
      device: where ``sample`` puts the items (default: the CUDA device).
    """

    def __init__(self, size: int, importance_sampling_exponent: float,
                 seed: int = 0, device=None):
        self.size = int(size)
        self.importance_sampling_exponent = importance_sampling_exponent
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        self._storage = None  # one numpy array per leaf
        self._structure = None  # _describe() of the inserted items
        self._priorities = np.zeros((self.size,), np.float64)
        self._insert_index = 0
        self._num_inserted = 0  # capped at size
        self._lock = threading.Lock()
        self._prefetch_thread = None
        self._prefetch_result = None
        self._stream = None  # the prefetch thread's CUDA stream

    @property
    def num_inserted(self) -> int:
        return self._num_inserted

    @property
    def insert_index(self) -> int:
        return self._insert_index

    def insert(self, items, priorities) -> np.ndarray:
        """FIFO insert of a batch of items (a tree of ``[batch, ...]``
        tensors or arrays; device tensors are copied to the host). Returns
        the inserted indices."""
        leaves = []
        structure = _describe(items, leaves)
        leaves = [_to_numpy(x) for x in leaves]
        priorities = _to_numpy(priorities).astype(np.float64)
        batch = priorities.shape[0]
        if batch > self.size:
            raise ValueError(
                f"cannot insert {batch} items into a buffer of {self.size}")
        if self._storage is None:
            self._structure = structure
            self._storage = [
                np.zeros((self.size,) + leaf.shape[1:], leaf.dtype)
                for leaf in leaves
            ]
        elif structure != self._structure:
            raise ValueError("inserted items do not match the buffer layout")
        start = self._insert_index
        indices = (start + np.arange(batch)) % self.size
        with self._lock:
            for store, vals in zip(self._storage, leaves):
                if start + batch <= self.size:
                    store[start:start + batch] = vals
                else:
                    head = self.size - start
                    store[start:] = vals[:head]
                    store[:batch - head] = vals[head:]
            self._priorities[indices] = priorities
            self._insert_index = (start + batch) % self.size
            self._num_inserted = min(self._num_inserted + batch, self.size)
        return indices.astype(np.int64)

    def _sample_host(self, num_samples: int, priority_exp: float):
        """Categorical draw + host gather. Called under the lock."""
        limit = self._num_inserted
        if limit == 0:
            raise ValueError("sampling from an empty replay buffer")
        if priority_exp == 0:
            indices = self._rng.integers(0, limit, size=num_samples)
            weights = np.ones((num_samples,), np.float32)
        else:
            p = self._priorities[:limit] ** priority_exp
            total = p.sum()
            cdf = np.cumsum(p)
            u = self._rng.random(num_samples) * total
            indices = np.searchsorted(cdf, u, side="right")
            indices = np.minimum(indices, limit - 1)
            probs = p[indices] / total
            weights = (
                (1.0 / limit) / np.maximum(probs, 1e-30)
            ) ** self.importance_sampling_exponent
            weights = (weights / weights.max()).astype(np.float32)
        gathered = [store[indices] for store in self._storage]
        return indices.astype(np.int64), weights, gathered

    def _upload(self, gathered):
        """The gathered leaves as tensors on the device; on the card copied
        on the caller's side stream, waited for, and marked as used on the
        default stream, where the learner reads them."""
        tensors = [torch.from_numpy(g) for g in gathered]
        if self.device.type != "cuda":
            return [t.to(self.device) for t in tensors]
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            out = [t.pin_memory().to(self.device, non_blocking=True)
                   for t in tensors]
        self._stream.synchronize()
        default = torch.cuda.default_stream(self.device)
        for t in out:
            t.record_stream(default)
        return out

    def sample(self, num_samples: int, priority_exp: float,
               to_device: bool = True
               ) -> Tuple[np.ndarray, np.ndarray, object]:
        """Returns (indices i64[n], weights f32[n], items ``[n, ...]``):
        the items as tensors on ``device``, or numpy arrays with
        ``to_device=False``."""
        with self._lock:
            indices, weights, gathered = self._sample_host(num_samples,
                                                           priority_exp)
        if to_device:
            gathered = self._upload(gathered)
        return indices, weights, _rebuild(self._structure, gathered)

    def upload(self, items):
        """``sample(..., to_device=False)``'s items as tensors on
        ``device``, copied as ``sample`` copies them."""
        leaves = []
        structure = _describe(items, leaves)
        return _rebuild(structure, self._upload(leaves))

    def sample_async(self, num_samples: int, priority_exp: float):
        """Starts gathering and copying the next batch on the prefetch
        thread."""
        if self._prefetch_thread is not None:
            raise RuntimeError("one prefetch in flight at most")
        result = {}

        def work():
            try:
                result["value"] = self.sample(num_samples, priority_exp)
            except BaseException as e:  # re-raised by wait_sample
                result["error"] = e

        self._prefetch_result = result
        self._prefetch_thread = threading.Thread(target=work, daemon=True)
        self._prefetch_thread.start()

    def wait_sample(self):
        """Blocks on the in-flight ``sample_async`` and returns its result,
        or raises what the prefetch thread raised."""
        if self._prefetch_thread is None:
            raise RuntimeError("no prefetch in flight")
        self._prefetch_thread.join()
        result = self._prefetch_result
        self._prefetch_thread = self._prefetch_result = None
        if "error" in result:
            raise RuntimeError("replay prefetch failed") from result["error"]
        return result["value"]

    def update_priorities(self, indices, priorities) -> None:
        priorities = _to_numpy(priorities).astype(np.float64)
        with self._lock:
            self._priorities[_to_numpy(indices)] = priorities

    def nbytes(self) -> int:
        """Host-RAM footprint of the storage arrays."""
        if self._storage is None:
            return 0
        return int(sum(s.nbytes for s in self._storage))

    # -- Persistence (the reference has none: its replay is RAM-only and a
    # -- restarted learner refills it from the current policy).

    def save(self, directory: str) -> None:
        """Writes the buffer under ``directory``, through
        ``directory + '.tmp'`` and two renames, so a crash mid-save leaves
        the previous snapshot whole (at ``<dir>.old`` at worst, which
        ``restore`` falls back to). Runs in the caller and holds the lock
        for the disk write."""
        if self._prefetch_thread is not None:
            raise RuntimeError("wait for the prefetch before a save")
        tmp = directory + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with self._lock:
            filled = self._num_inserted
            meta = {
                "size": self.size,
                "insert_index": self._insert_index,
                "num_inserted": filled,
                "num_leaves": 0 if self._storage is None else len(
                    self._storage),
                "structure": self._structure,
            }
            np.save(os.path.join(tmp, "priorities.npy"), self._priorities)
            for i, leaf in enumerate(self._storage or ()):
                np.save(os.path.join(tmp, f"leaf_{i}.npy"), leaf[:filled])
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
        old = directory + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        if os.path.exists(directory):
            os.rename(directory, old)
        os.rename(tmp, directory)
        if os.path.exists(old):
            shutil.rmtree(old)

    def restore(self, directory: str) -> bool:
        """Loads a ``save`` snapshot; returns False if there is none."""
        meta_path = os.path.join(directory, "meta.json")
        if not os.path.exists(meta_path):
            # A crash between save()'s two renames parks the previous
            # snapshot at <dir>.old.
            directory = directory + ".old"
            meta_path = os.path.join(directory, "meta.json")
            if not os.path.exists(meta_path):
                return False
        if self._prefetch_thread is not None:
            raise RuntimeError("wait for the prefetch before a restore")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta["size"] != self.size:
            raise ValueError(
                f"replay snapshot size {meta['size']} != configured "
                f"--replay_buffer_size {self.size}; use a matching size or "
                "a fresh replay directory")
        storage = None
        if meta["num_leaves"]:
            storage = []
            for i in range(meta["num_leaves"]):
                saved = np.load(os.path.join(directory, f"leaf_{i}.npy"),
                                mmap_mode="r")
                leaf = np.zeros((self.size,) + saved.shape[1:], saved.dtype)
                leaf[:len(saved)] = saved
                storage.append(leaf)
        with self._lock:
            self._priorities = np.load(
                os.path.join(directory, "priorities.npy")).astype(np.float64)
            self._insert_index = int(meta["insert_index"])
            self._num_inserted = int(meta["num_inserted"])
            self._structure = meta["structure"]
            self._storage = storage
        return True
