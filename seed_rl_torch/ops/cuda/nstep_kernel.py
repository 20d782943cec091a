"""Fused n-step targets and priorities on the card: wrapper of
``csrc/nstep_kernel.cu``.

Port of the TPU kernel ``seed_rl_tpu/ops/pallas/nstep_kernel.py`` (the
Pallas ``_nstep_kernel`` behind ``td_loss_and_priorities``). The kernel is
CUDA C++ for sm_90a, built with nvcc at first use and bound through a plain
C function loaded with ctypes (see ``build.py``).

``td_loss_and_priorities`` has the plain version's signature and returns
``(loss [B], priorities [B])``. The two gathers (online Q at the replayed
action, target Q at the online argmax) stay PyTorch, as in the JAX
package. The kernel takes their results, the rewards and ``done`` and
writes the ``[T-1, B]`` rescaled targets and the priorities, both
stop-gradient; the loss ``0.5 * sum_t (target - Q_replay)^2`` is formed
here from the differentiable gathered Q, which is where gradients flow. For
CPU tensors both functions run the plain version
(``seed_rl_torch.ops.value_ops``); for CUDA tensors they launch the kernel
on the current stream or raise. ``done`` goes to the kernel as it comes,
bool bytes or f32, without a cast.

``launch_plan`` picks the kernel's row chunk and staged window from the
shape; the kernel takes its block shape and shared memory from its own
constants and the plan. ``launch_shape`` asks the built kernel what launch
a shape gets.
"""

import ctypes
from typing import NamedTuple, Tuple

import torch

from seed_rl_torch.ops import value_ops
from seed_rl_torch.ops.cuda import build, run_count

KERNEL_NAME = "nstep_kernel"

_library_handle = None

# The largest chunk of output rows and halo of staged rows
# csrc/nstep_kernel.cu is built for (kMaxChunk, kMaxHalo).
MAX_CHUNK, MAX_HALO = 128, 64


class LaunchPlan(NamedTuple):
    chunk: int  # output rows per chunk: chunk k takes [k * chunk, ...)
    window: int  # rows of rewards and done staged per chunk


class LaunchShape(NamedTuple):
    blocks: int
    threads: int  # per block
    smem_bytes: int  # per block


def launch_plan(T: int, n_steps: int) -> LaunchPlan:
    """The kernel's chunking of [T, B] inputs: the ``T - 1`` output rows in
    chunks of at most ``MAX_CHUNK``, each staging its rows of rewards and
    done plus a halo of up to ``n_steps - 1`` rows (at most ``MAX_HALO``;
    the kernel reads rows past it from device memory)."""
    if T < 2 or n_steps < 1:
        raise ValueError(f"no n-step launch for T={T}, n={n_steps}")
    chunk = min(T - 1, MAX_CHUNK)
    return LaunchPlan(chunk, min(chunk + min(n_steps - 1, MAX_HALO), T - 1))


def _library():
    global _library_handle
    if _library_handle is None:
        lib = build.load_library(KERNEL_NAME)
        ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.seed_rl_nstep_forward.argtypes = (
            [ptr] * 6 + [i32, i32, i32, f64, f64, f64, i32, i32, i32, ptr])
        lib.seed_rl_nstep_launch_shape.argtypes = (
            [i32] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3)
        _library_handle = lib
    return _library_handle


def launch_shape(T: int, B: int, n_steps: int) -> LaunchShape:
    """The launch the built kernel makes for [T, B] inputs."""
    out = [ctypes.c_int() for _ in LaunchShape._fields]
    err = _library().seed_rl_nstep_launch_shape(
        B, *launch_plan(T, n_steps), *map(ctypes.byref, out))
    if err != 0:
        raise ValueError(f"no n-step launch for T={T}, B={B}, n={n_steps}")
    return LaunchShape(*(x.value for x in out))


def _check(q_values, target_q_values, online_argmax_action, replay_action,
           rewards, done, n_steps):
    """Raises on inputs neither version takes; True for the CPU path."""
    inputs = (q_values, target_q_values, online_argmax_action, replay_action,
              rewards, done)
    devices = {x.device for x in inputs}
    if len(devices) != 1 or next(iter(devices)).type not in ("cpu", "cuda"):
        raise ValueError(
            f"n-step inputs must all lie on one CUDA device or all on the "
            f"CPU, got {sorted(map(str, devices))}"
        )
    for x in (q_values, target_q_values, rewards):
        if not x.is_floating_point():
            raise TypeError(f"Q values and rewards must be floating, "
                            f"got {x.dtype}")
    for x in (online_argmax_action, replay_action):
        if x.is_floating_point() or x.dtype == torch.bool:
            raise TypeError(f"actions must be integers, got {x.dtype}")
    if not (done.dtype == torch.bool or done.is_floating_point()):
        raise TypeError(f"done must be bool or floating, got {done.dtype}")
    if q_values.dim() != 3:
        raise ValueError(
            f"q_values must be [T, B, A], got {tuple(q_values.shape)}")
    T, B, _ = q_values.shape
    if T < 2 or B < 1:
        raise ValueError(
            f"the n-step targets need T >= 2 (one target row) and B >= 1, "
            f"got [{T}, {B}]")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if target_q_values.shape != q_values.shape:
        raise ValueError(f"target_q_values must be {tuple(q_values.shape)}, "
                         f"got {tuple(target_q_values.shape)}")
    for x in (online_argmax_action, replay_action, rewards, done):
        if x.shape != (T, B):
            raise ValueError(f"expected [{T}, {B}], got {tuple(x.shape)}")
    if not (rewards.is_contiguous() and done.is_contiguous()):
        raise ValueError("n-step kernel inputs (rewards, done) must be "
                         "contiguous")
    return q_values.device.type == "cpu"


def td_loss_and_priorities(
    q_values: torch.Tensor,
    target_q_values: torch.Tensor,
    online_argmax_action: torch.Tensor,
    replay_action: torch.Tensor,
    rewards: torch.Tensor,
    done: torch.Tensor,
    gamma: float,
    n_steps: int,
    eta: float = 0.9,
    rescaling_eps: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence double-DQN loss and priorities; the contract of
    ``seed_rl_torch.ops.value_ops.td_loss_and_priorities``."""
    on_cpu = _check(q_values, target_q_values, online_argmax_action,
                    replay_action, rewards, done, n_steps)
    if on_cpu:
        return value_ops.td_loss_and_priorities(
            q_values, target_q_values, online_argmax_action, replay_action,
            rewards, done, gamma=gamma, n_steps=n_steps, eta=eta,
            rescaling_eps=rescaling_eps,
        )
    T, B, _ = q_values.shape
    replay_q = value_ops.gather_actions(
        q_values.to(torch.float32), replay_action)
    with torch.no_grad():
        qtarget_max = value_ops.gather_actions(
            target_q_values.to(torch.float32), online_argmax_action
        ).contiguous()
        kernel_q = replay_q.detach().contiguous()
        rewards_f = rewards.detach().to(torch.float32)
        done_is_bool = done.dtype == torch.bool
        done_k = done.detach() if done_is_bool else done.detach().to(
            torch.float32)
    targets = torch.empty((T - 1, B), dtype=torch.float32,
                          device=q_values.device)
    priorities = torch.empty((B,), dtype=torch.float32,
                             device=q_values.device)
    plan = launch_plan(T, int(n_steps))
    lib = _library()
    with torch.cuda.device(q_values.device):
        err = lib.seed_rl_nstep_forward(
            qtarget_max.data_ptr(), rewards_f.data_ptr(), done_k.data_ptr(),
            kernel_q.data_ptr(), targets.data_ptr(), priorities.data_ptr(),
            T, B, int(n_steps), float(gamma), float(eta),
            float(rescaling_eps), int(done_is_bool), plan.chunk, plan.window,
            torch.cuda.current_stream(q_values.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(
                f"n-step kernel launch failed: CUDA error {err}")
        run_count.add(KERNEL_NAME, q_values.device)
    loss = 0.5 * torch.sum(torch.square(targets - replay_q[:-1]), dim=0)
    return loss, priorities


def td_loss_and_priorities_dispatch(*args, **kwargs):
    """The JAX package's dispatch name: the kernel for CUDA tensors, the
    plain version for CPU tensors (``td_loss_and_priorities`` decides by
    the inputs' device)."""
    return td_loss_and_priorities(*args, **kwargs)
