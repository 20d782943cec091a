"""Fused V-trace on the card: wrapper of ``csrc/vtrace_kernel.cu``.

Port of the TPU kernel ``seed_rl_tpu/ops/pallas/vtrace_kernel.py`` (the
Pallas ``_vtrace_kernel`` behind ``from_importance_weights``). The kernel
is CUDA C++ for sm_90a, built with nvcc at first use and bound through a
plain C function loaded with ctypes (see ``build.py``).

``from_importance_weights`` has the plain version's signature. For CPU
tensors it runs the plain version (``seed_rl_torch.ops.vtrace``); for CUDA
tensors it launches the kernel on the current stream or raises. Both
outputs are stop-gradient, as on the TPU: the inputs are detached.

``launch_plan`` picks the kernel's row chunk and staging buffers from the
shape; the kernel takes its block shape and shared memory from its own
constants and the plan. ``launch_shape`` asks the built kernel what launch
a shape gets. ``launch_floor`` launches the empty kernel beside it, the
least any launch costs on the card.
"""

import ctypes
from typing import NamedTuple, Optional

import torch

from seed_rl_torch.ops import vtrace as vtrace_plain
from seed_rl_torch.ops.cuda import build, run_count

KERNEL_NAME = "vtrace_kernel"

_library_handle = None

# The largest chunk of rows csrc/vtrace_kernel.cu is built for (kMaxChunk).
MAX_CHUNK = 32


class LaunchPlan(NamedTuple):
    chunk: int  # rows per chunk, walked from the last chunk to the first
    buffers: int  # staging buffers: 2 where T spans several chunks


class LaunchShape(NamedTuple):
    blocks: int
    threads: int  # per block
    smem_bytes: int  # per block


def launch_plan(T: int) -> LaunchPlan:
    """The kernel's chunking of T rows: chunk k takes rows
    ``[k * chunk, (k + 1) * chunk)``, the last chunk first; while one chunk
    is computed the one before it is staged into the other buffer."""
    if T < 1:
        raise ValueError(f"no V-trace launch for T={T}")
    chunk = min(T, MAX_CHUNK)
    return LaunchPlan(chunk, 1 if T <= chunk else 2)


def _library():
    global _library_handle
    if _library_handle is None:
        lib = build.load_library(KERNEL_NAME)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.seed_rl_vtrace_forward.argtypes = (
            [ptr] * 8 + [i32, i32, i32, f32, i32, f32, f32, i32, i32, ptr])
        lib.seed_rl_vtrace_launch_shape.argtypes = (
            [i32] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3)
        lib.seed_rl_launch_floor.argtypes = [ptr]
        _library_handle = lib
    return _library_handle


def launch_shape(T: int, B: int) -> LaunchShape:
    """The launch the built kernel makes for [T, B] inputs."""
    out = [ctypes.c_int() for _ in LaunchShape._fields]
    err = _library().seed_rl_vtrace_launch_shape(
        T, B, *launch_plan(T), *map(ctypes.byref, out))
    if err != 0:
        raise ValueError(f"no V-trace launch for T={T}, B={B}")
    return LaunchShape(*(x.value for x in out))


def launch_floor(device: torch.device) -> None:
    """Launches the empty kernel of ``csrc/vtrace_kernel.cu`` (one block of
    32 threads) on the current stream; counted nowhere."""
    with torch.cuda.device(device):
        err = _library().seed_rl_launch_floor(
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def from_importance_weights(
    target_action_log_probs: torch.Tensor,
    behaviour_action_log_probs: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
    lambda_: float = 1.0,
) -> vtrace_plain.VTraceReturns:
    """V-trace; same contract as ``seed_rl_torch.ops.vtrace``."""
    inputs = [
        target_action_log_probs, behaviour_action_log_probs, discounts,
        rewards, values, bootstrap_value,
    ]
    devices = {x.device for x in inputs}
    if devices == {torch.device("cpu")}:
        return vtrace_plain.from_importance_weights(
            *inputs,
            clip_rho_threshold=clip_rho_threshold,
            clip_pg_rho_threshold=clip_pg_rho_threshold,
            lambda_=lambda_,
        )
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"V-trace inputs must all lie on one CUDA device or all on the "
            f"CPU, got {sorted(map(str, devices))}"
        )
    for x in inputs:
        if not x.is_floating_point():
            raise TypeError(f"V-trace inputs must be floating, got {x.dtype}")
    inputs = [x.detach().to(torch.float32) for x in inputs]
    (target, behaviour, discounts, rewards, values, bootstrap) = inputs
    if rewards.dim() != 2:
        raise ValueError(f"rewards must be [T, B], got {tuple(rewards.shape)}")
    T, B = rewards.shape
    if T == 0 or B == 0:
        raise ValueError(f"V-trace needs T >= 1 and B >= 1, got [{T}, {B}]")
    for x in (target, behaviour, discounts, values):
        if x.shape != (T, B):
            raise ValueError(f"expected [{T}, {B}], got {tuple(x.shape)}")
    if bootstrap.shape != (B,):
        raise ValueError(
            f"bootstrap_value must be [{B}], got {tuple(bootstrap.shape)}"
        )
    if not all(x.is_contiguous() for x in inputs):
        raise ValueError("V-trace kernel inputs must be contiguous")

    vs = torch.empty_like(values)
    pg_advantages = torch.empty_like(values)
    device = values.device
    plan = launch_plan(T)
    with torch.cuda.device(device):
        err = _library().seed_rl_vtrace_forward(
            target.data_ptr(), behaviour.data_ptr(), discounts.data_ptr(),
            rewards.data_ptr(), values.data_ptr(), bootstrap.data_ptr(),
            vs.data_ptr(), pg_advantages.data_ptr(),
            T, B,
            int(clip_rho_threshold is not None),
            float(clip_rho_threshold or 0.0),
            int(clip_pg_rho_threshold is not None),
            float(clip_pg_rho_threshold or 0.0),
            float(lambda_), plan.chunk, plan.buffers,
            torch.cuda.current_stream(device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(
                f"V-trace kernel launch failed: CUDA error {err}")
        run_count.add(KERNEL_NAME, device)
    return vtrace_plain.VTraceReturns(vs=vs, pg_advantages=pg_advantages)
