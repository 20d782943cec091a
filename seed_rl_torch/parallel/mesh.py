"""The data-parallel mesh over ``torch.distributed``.

Port of ``seed_rl_tpu/parallel/mesh.py``. The JAX package factors every
device into one ``(replica, model)`` mesh and runs one global-array program
over it; here each replica is a process (a rank) that holds its share of
the envs and the replay, and a ``Mesh`` is one rank's view of the group:
its rank, the world size, its device and the process group. Ranks on the
card talk over NCCL and ranks on the CPU over gloo: the backend follows
the device the caller asked for, unless named.

The collectives the learners need are methods here: an all-reduce sum that
autograd differentiates (``sum``: its backward all-reduces the incoming
gradient, so every rank's loss holds the global value and its gradient the
rank's share times the world size), the gradient average before the
optimizer step (``average_``), gathers, and the rank-0 decisions every rank
follows (``broadcast_object``). On one rank every collective is the
identity, so a one-rank mesh runs the single-device program.

``model_parallelism`` is kept for the JAX signature; the JAX package
reserves that axis and shards nothing on it, and a value above 1 raises.
"""

import datetime
import multiprocessing
import queue
import socket
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from seed_rl_torch.parallel.draws import ShardedGenerator
from seed_rl_torch.utils.tree import SIGNED_VIEW

def _to_wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a type NCCL and gloo both carry, sharing its memory: bool
    as uint8, uint16 (the Football env's frames; neither carries 16-bit
    integers) as its two bytes on a new last axis, uint32 / uint64 as
    their signed view."""
    if x.dtype == torch.bool:
        return x.view(torch.uint8)
    if x.dtype == torch.uint16:
        return x.unsqueeze(-1).view(torch.uint8)
    return x.view(SIGNED_VIEW.get(x.dtype, x.dtype))


def _from_wire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of ``_to_wire`` for a tensor that was ``dtype``."""
    if dtype == torch.uint16:
        return x.view(torch.uint16).squeeze(-1)
    return x.view(dtype)


class _AllReduceSum(torch.autograd.Function):
    """An all-reduce sum whose backward all-reduces the gradient (the
    gradient of every rank's copy of the sum reaches every rank's part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


class Mesh:
    """One rank's view of a data-parallel mesh of ``size`` ranks.

    Args:
      rank: this process's rank.
      size: the number of ranks (replicas).
      device: this rank's device.
      group: the process group (None: the default group).
      collective: whether the collectives run; by default only with more
        than one rank. A one-rank mesh over a real process group (``make_mesh``
        in an initialised group of one) runs them, so that its backend's
        all-reduce launches.
    """

    def __init__(self, rank: int, size: int, device, group=None,
                 collective: Optional[bool] = None):
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.group = group
        self.collective = size > 1 if collective is None else collective

    def __repr__(self):
        return f"Mesh(rank={self.rank}, size={self.size}, device={self.device})"

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend(self.group) if self.collective else None

    def shard(self, total: int) -> slice:
        """This rank's contiguous share ``[r*n/N, (r+1)*n/N)`` of ``total``
        global items (envs, replay slots); ``total`` must divide evenly."""
        if total % self.size:
            raise ValueError(f"{total} does not divide over {self.size} "
                             "replicas")
        per = total // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def draws(self, generator: torch.Generator, total: int,
              axis: int = 0) -> ShardedGenerator:
        """``generator`` keeping this rank's share of ``total`` along
        ``axis`` of every draw (``draws``): on one rank, all of it."""
        return ShardedGenerator(generator, total, self.shard(total), axis)

    # -- collectives (the identity on one rank) ------------------------------

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The all-reduced sum of ``x``; differentiable, its backward
        all-reduces the gradient."""
        if not self.collective:
            return x
        if x.requires_grad:
            return _AllReduceSum.apply(x, self.group)
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group)
        return out

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The all-reduced maximum of ``x`` (not differentiable)."""
        if not self.collective:
            return x
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def average_(self, tensors: List[torch.Tensor]):
        """Replaces ``tensors`` by their mean over the ranks, in place, in
        one all-reduce of their concatenation: NCCL averages inside the
        collective (a sum of the parts scaled by 1/N, a kernel of its own
        even on one rank); gloo has no average, so its sum is divided."""
        if not self.collective or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if self.backend == "nccl":
            dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=self.group)
        else:
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.size)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order; the
        ranks' sizes along ``dim`` may differ (not differentiable)."""
        if not self.collective:
            return x
        x = x.detach()
        counts = self.all_gather_counts(x.shape[dim])
        longest = max(counts)
        moved = _to_wire(x.movedim(dim, 0))
        padded = torch.zeros((longest,) + tuple(moved.shape[1:]),
                             dtype=moved.dtype, device=moved.device)
        padded[:moved.shape[0]] = moved
        parts = [torch.empty_like(padded) for _ in range(self.size)]
        dist.all_gather(parts, padded, group=self.group)
        out = torch.cat([p[:n] for p, n in zip(parts, counts)])
        return _from_wire(out, x.dtype).movedim(0, dim)

    def all_gather_counts(self, count: int) -> List[int]:
        """Every rank's ``count``, in rank order."""
        if not self.collective:
            return [count]
        device = self.device if self.backend == "nccl" else "cpu"
        mine = torch.tensor([count], dtype=torch.int64, device=device)
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(parts, mine, group=self.group)
        return [int(p) for p in parts]

    def gather_to_host(self, x: torch.Tensor, dim: int = 0):
        """Every rank's ``x`` concatenated along ``dim`` in rank order, on
        rank 0's CPU; on the other ranks a meta tensor of that shape. The
        parts cross one at a time (a broadcast from each owner), so a card
        holds at most one other rank's part beside its own (a checkpoint's
        leaf)."""
        if not self.collective:
            return x
        counts = self.all_gather_counts(x.shape[dim])
        moved = _to_wire(x.detach().movedim(dim, 0))
        parts = []
        for rank, count in enumerate(counts):
            if not count:
                continue
            part = (moved.contiguous() if rank == self.rank else torch.empty(
                (count,) + tuple(moved.shape[1:]), dtype=moved.dtype,
                device=moved.device))
            dist.broadcast(part, src=rank, group=self.group)
            if self.rank == 0:
                parts.append(part.cpu())
            del part
        shape = (sum(counts),) + tuple(moved.shape[1:])
        out = (torch.cat(parts) if parts else torch.empty(
            shape, dtype=moved.dtype, device="cpu" if self.rank == 0
            else "meta"))
        return _from_wire(out, x.dtype).movedim(0, dim)

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Rank ``src``'s ``obj`` on every rank (a host value: a decision,
        a step)."""
        if not self.collective:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src=src, group=self.group,
            device=self.device if self.backend == "nccl" else None)
        return box[0]

    def barrier(self):
        if self.collective:
            dist.barrier(group=self.group)


def backend_for(device) -> str:
    """NCCL for ranks on the card, gloo for ranks on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_mesh(
    num_replicas: Optional[int] = None,
    model_parallelism: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """This process's view of a ``num_replicas``-rank mesh.

    Without an initialised process group the mesh has one rank. With one,
    ``num_replicas`` (default: the world size) must be the world size, and
    rank r runs on ``devices[r]``: by default ``cuda:r`` when CUDA is up,
    whatever the group's backend, else the CPU; ranks on the CPU of a
    machine with a card are asked for by passing them. More ranks than
    devices raises, as the JAX package's ``make_mesh`` asserts.
    """
    if model_parallelism != 1:
        raise NotImplementedError(
            "model_parallelism > 1: the JAX package reserves the model axis "
            "and shards nothing on it")
    initialized = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if initialized else 0
    world = dist.get_world_size() if initialized else 1
    if num_replicas is None:
        num_replicas = world
    if num_replicas != world:
        raise ValueError(f"a mesh of {num_replicas} replicas needs a process "
                         f"group of that size; this one has {world}")
    if devices is None:
        # The card by default, whatever the backend: ranks on the CPU are
        # asked for by passing them.
        if torch.cuda.is_available():
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device("cpu")] * world
    if num_replicas > len(devices):
        raise ValueError(f"{num_replicas} replicas need as many devices; "
                         f"there are {len(devices)}")
    return Mesh(rank, world, devices[rank], collective=initialized)


def init_multi_host(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_secs: float = 1800.0,
):
    """Joins this process to a ``num_processes``-rank group at
    ``coordinator_address`` (``host:port``, rank 0's listening address),
    as ``process_id``; on one process this is a no-op, as in the JAX
    package. The backend defaults to NCCL where CUDA is up, else gloo."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "gloo" and not dist.is_gloo_available():
        raise ValueError("this torch build has no gloo backend")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_secs))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, num_replicas, address, backend, devices,
               timeout_secs, threads, args, results):
    previous_threads = torch.get_num_threads()
    try:
        if threads:
            torch.set_num_threads(threads)
        init_multi_host(address, num_replicas, rank, backend, timeout_secs)
        mesh = make_mesh(num_replicas, devices=devices)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        try:
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        if results is not None:
            results.put((rank, out, None))
        return out
    except Exception:
        if results is None:
            raise
        results.put((rank, None, traceback.format_exc()))
        return None
    finally:
        torch.set_num_threads(previous_threads)


def spawn(
    fn: Callable[..., Any],
    num_replicas: int,
    device="cuda",
    backend: Optional[str] = None,
    args: tuple = (),
    devices: Optional[Sequence] = None,
    timeout_secs: float = 1800.0,
    threads: Optional[int] = None,
) -> List[Any]:
    """Runs ``fn(mesh, *args)`` on ``num_replicas`` ranks and returns every
    rank's result, in rank order.

    Rank 0 runs in this process (so its result comes back as it is: a
    learner, say); ranks 1.. run in processes of the ``spawn`` start method
    (CUDA may be live here already) and send their results back pickled.
    ``fn`` must be importable by name from a module the children can load.
    The backend follows ``device`` (NCCL on the card, gloo on the CPU)
    unless given; rank r runs on ``devices[r]``, by default ``cuda:r`` on
    the card. ``threads`` sets each rank's torch thread count.
    """
    device = torch.device(device)
    backend = backend or backend_for(device)
    if backend == "gloo" and not dist.is_gloo_available():
        raise ValueError("this torch build has no gloo backend")
    if devices is None:
        if device.type == "cuda":
            if num_replicas > torch.cuda.device_count():
                raise ValueError(
                    f"{num_replicas} ranks need as many CUDA devices; "
                    f"there are {torch.cuda.device_count()}")
            devices = [torch.device("cuda", i) for i in range(num_replicas)]
        else:
            devices = [device] * num_replicas
    devices = [str(d) for d in devices]
    if num_replicas == 1:
        return [fn(Mesh(0, 1, devices[0]), *args)]
    address = f"localhost:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    children = [ctx.Process(
        target=_rank_main,
        args=(fn, rank, num_replicas, address, backend, devices,
              timeout_secs, threads, args, results), daemon=True)
        for rank in range(1, num_replicas)]
    for child in children:
        child.start()
    outs: List[Any] = [None] * num_replicas
    try:
        outs[0] = _rank_main(fn, 0, num_replicas, address, backend, devices,
                             timeout_secs, threads, args, None)
        errors, pending = [], set(range(1, num_replicas))
        while pending:
            try:
                rank, out, error = results.get(timeout=5.0)
            except queue.Empty:
                gone = [r for r in sorted(pending)
                        if not children[r - 1].is_alive()]
                if gone:
                    raise RuntimeError(f"ranks {gone} exited without a "
                                       "result") from None
                continue
            pending.discard(rank)
            outs[rank] = out
            if error:
                errors.append(f"rank {rank}:\n{error}")
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    finally:
        for child in children:
            child.join(timeout=60)
            if child.is_alive():
                child.kill()
                child.join()
    return outs

