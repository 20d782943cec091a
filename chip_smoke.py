"""Smoke test of the PyTorch port (seed_rl_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. print the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build every CUDA kernel of the training path from seed_rl_torch/csrc;
  3. hold each kernel against its plain PyTorch version on the card;
  4. time each kernel and its plain version with CUDA events, beside the
     least time the card could take for the same work;
  5. train V-trace on the toy env through seed_rl_torch.train.main at the
     default MLPAndLSTM width (num_envs=1024, unroll_length=32), with the
     kernel launch counts reset just before, and check that every kernel
     of the path was launched once per train step, that everything lives
     on the card, and that the metrics are finite;
  6. print the kernels line (JSON) and the TPU kernels still to port.
The last line of standard output is the device JSON:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

It exits non-zero and prints no result where torch sees no CUDA device, or
where the seed_rl_torch package is absent.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

VTRACE_TOL = 1e-5
# (T, B, lambda_, clip_rho_threshold, clip_pg_rho_threshold)
VTRACE_CASES = (
    (32, 1024, 1.0, 1.0, 1.0),  # the main path below: unroll 32, 1024 envs
    (10, 64, 1.0, 1.0, 1.0),  # the README quick-start shape
    (12, 256, 0.95, 1.0, 1.0),
    (5, 128, 1.0, None, None),
    (1, 37, 1.0, 1.0, 1.0),
)
# Arithmetic of one [t, b] element in csrc/vtrace_kernel.cu (exp counted
# as one): log-ratio, exp, 3 clips, lambda, delta 4, recursion 3, vs 1,
# pg advantage 4.
VTRACE_OPS_PER_ELEMENT = 18

TRAIN_ENVS, TRAIN_UNROLL, TRAIN_STEPS, TIMED_STEPS = 1024, 32, 4, 10


def _vtrace_inputs(T, B, seed, device):
    rng = np.random.RandomState(seed)
    arrays = [
        rng.uniform(-1, 1, (T, B)),  # target log-probs
        rng.uniform(-1, 1, (T, B)),  # behaviour log-probs
        rng.binomial(1, 0.9, (T, B)) * 0.99,  # discounts
        rng.normal(size=(T, B)),  # rewards
        rng.normal(size=(T, B)),  # values
        rng.normal(size=(B,)),  # bootstrap
    ]
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


def _vtrace_bound_ms(T, B):
    bytes_moved = ((5 * T + 1) * B + 2 * T * B) * 4
    ops = VTRACE_OPS_PER_ELEMENT * T * B
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else
                                   "operations")


def _cuda_ms(fn, iters, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_vtrace_kernel(device):
    """Phase 3: kernel vs plain version on every case; returns max |err|."""
    from seed_rl_torch.ops import vtrace as plain
    from seed_rl_torch.ops.cuda import vtrace_kernel

    max_err = 0.0
    for seed, (T, B, lam, clip_rho, clip_pg) in enumerate(VTRACE_CASES):
        args = _vtrace_inputs(T, B, seed, device)
        kwargs = dict(clip_rho_threshold=clip_rho,
                      clip_pg_rho_threshold=clip_pg, lambda_=lam)
        got = vtrace_kernel.from_importance_weights(*args, **kwargs)
        want = plain.from_importance_weights(*args, **kwargs)
        torch.cuda.synchronize()
        for name, g, w in zip(("vs", "pg_advantages"), got, want):
            torch.testing.assert_close(g, w, rtol=VTRACE_TOL, atol=VTRACE_TOL)
            err = float((g - w).abs().max())
            max_err = max(max_err, err)
            print(f"vtrace T={T} B={B} lambda={lam} clip={clip_rho}: "
                  f"{name} max|err|={err:.3e} (tol {VTRACE_TOL})")
    return max_err


def time_vtrace_kernel(device):
    """Phase 4: kernel and plain times at the main-path shape."""
    from seed_rl_torch.ops import vtrace as plain
    from seed_rl_torch.ops.cuda import vtrace_kernel

    T, B = TRAIN_UNROLL, TRAIN_ENVS
    args = _vtrace_inputs(T, B, 0, device)
    kernel_ms = _cuda_ms(
        lambda: vtrace_kernel.from_importance_weights(*args), iters=200)
    plain_ms = _cuda_ms(
        lambda: plain.from_importance_weights(*args), iters=20)
    bound_ms, bound_by = _vtrace_bound_ms(T, B)
    print(f"vtrace T={T} B={B}: kernel {kernel_ms:.6f} ms per call "
          f"(CUDA events over back-to-back calls), plain {plain_ms:.6f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by})")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(20):
            vtrace_kernel.from_importance_weights(*args)
        torch.cuda.synchronize()
    rows = [e for e in _device_kernels(p) if "vtrace" in e.key]
    if rows:
        device_ms = rows[0].self_device_time_total / rows[0].count / 1e3
        print(f"vtrace T={T} B={B}: kernel alone on the device "
              f"{device_ms:.6f} ms (torch.profiler, {rows[0].count} launches)")
    else:
        print("vtrace kernel device time: not measured (no profiler rows)")
    return kernel_ms, plain_ms, bound_ms, bound_by


def run_training(device_name):
    """Phase 5: the port's main path through its CLI entry point."""
    from seed_rl_torch import train
    from seed_rl_torch.agents import vtrace as vtrace_agent
    from seed_rl_torch.ops import vtrace as plain
    from seed_rl_torch.ops.cuda import vtrace_kernel

    argv = [
        "--agent=vtrace", "--env=toy",
        f"--num_envs={TRAIN_ENVS}", f"--unroll_length={TRAIN_UNROLL}",
        f"--total_environment_frames={TRAIN_STEPS * TRAIN_ENVS * TRAIN_UNROLL}",
        "--steps_per_call=1", "--log_every_steps=1",
    ]
    vtrace_kernel.launches = 0
    t0 = time.perf_counter()
    learner, state, metrics = train.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"vtrace": vtrace_kernel.launches}
    if state.step != TRAIN_STEPS:
        raise RuntimeError(f"trained {state.step} steps, want {TRAIN_STEPS}")
    if launches["vtrace"] != state.step:
        raise RuntimeError(
            f"vtrace kernel launched {launches['vtrace']} times in "
            f"{state.step} train steps")
    bad = {k: float(v) for k, v in metrics.items()
           if not math.isfinite(float(v))}
    if bad:
        raise RuntimeError(f"non-finite metrics: {bad}")
    tensors = list(learner.parameters()) + learner.state_tensors(state)
    off_card = [t.device for t in tensors if t.device.type != "cuda"]
    if off_card:
        raise RuntimeError(f"{len(off_card)} tensors off the card")
    print(f"train: {state.step} steps in {wall_s:.3f} s including setup; "
          f"losses/total={float(metrics['losses/total']):.6f}; "
          f"{len(tensors)} tensors on cuda")

    # The kernel on this run's own data, against the plain version.
    rollout, unroll = learner.engine.rollout(state.rollout)
    state = state._replace(rollout=rollout)
    with torch.no_grad():
        inputs, _ = vtrace_agent.vtrace_inputs(
            learner.config, learner.agent, learner.agent.distribution, unroll)
    got = vtrace_kernel.from_importance_weights(
        **inputs, lambda_=learner.config.lambda_)
    want = plain.from_importance_weights(
        **inputs, lambda_=learner.config.lambda_)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=VTRACE_TOL, atol=VTRACE_TOL)
    print("vtrace on the run's own unroll matches the plain version")

    for _ in range(2):  # warm
        state, _ = learner.train_step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, metrics = learner.train_step(state)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    frames_per_s = learner.frames_per_step / step_s
    print(f"train step on {device_name}: {step_s * 1e3:.3f} ms, "
          f"{frames_per_s:.1f} env frames/s "
          f"(num_envs={TRAIN_ENVS}, unroll_length={TRAIN_UNROLL}, "
          f"MLPAndLSTM (64,64)+(64,))")

    # Where the step's time goes: the rollout and the update alone.
    rollout_s = update_s = 0.0
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        rollout, unroll = learner.engine.rollout(state.rollout)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, _ = learner.update(state._replace(rollout=rollout), unroll)
        torch.cuda.synchronize()
        rollout_s += t1 - t0
        update_s += time.perf_counter() - t1
    print(f"per step: rollout {rollout_s / TIMED_STEPS * 1e3:.3f} ms, "
          f"update (loss, backward, clip, Adam, stats) "
          f"{update_s / TIMED_STEPS * 1e3:.3f} ms")
    profile_device_time(learner, state, step_s)
    return launches


def _device_kernels(prof):
    """Kernel rows of a profile; annotation ranges that also appear as host
    ops (e.g. ``Optimizer.step#Adam.step``) would count their kernels twice."""
    from torch.autograd import DeviceType

    rows = prof.key_averages()
    host = {e.key for e in rows if e.device_type == DeviceType.CPU}
    return [e for e in rows
            if e.device_type == DeviceType.CUDA and e.key not in host]


def profile_device_time(learner, state, step_s, steps=3):
    """Device busy time per step from torch.profiler, and the idle share
    against the unprofiled step time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(steps):
            state, _ = learner.train_step(state)
        torch.cuda.synchronize()
    kernels = _device_kernels(p)
    busy_us = sum(e.self_device_time_total for e in kernels) / steps
    launches = sum(e.count for e in kernels) / steps
    if busy_us == 0:
        print("profiler: no device time recorded; device busy share not "
              "measured")
        return
    print(f"profiler: device busy {busy_us / 1e3:.3f} ms per step over "
          f"{launches:.0f} kernel launches; idle share "
          f"{1 - busy_us / 1e6 / step_s:.3f} of the {step_s * 1e3:.3f} ms step")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"  {e.self_device_time_total / steps / 1e3:9.3f} ms/step "
              f"{e.count / steps:6.0f}x  {e.key[:90]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device visible to torch", file=sys.stderr)
        return 1
    from seed_rl_torch.ops.cuda import build  # fails outside a checkout

    device = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    build.build(["vtrace_kernel"])
    print(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in build.build_logs.items():
        print(f"--- nvcc {name}\n{log.strip()}")

    max_err = check_vtrace_kernel(device)
    kernel_ms, plain_ms, bound_ms, bound_by = time_vtrace_kernel(device)
    launches = run_training(device_name)

    kernels = [{
        "name": "vtrace",
        "route": "cuda",
        "source": "seed_rl_torch/csrc/vtrace_kernel.cu",
        "replaces": "seed_rl_tpu/ops/pallas/vtrace_kernel.py:29",
        "launches": launches["vtrace"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes V-trace
    }]
    print("not ported yet: nstep seed_rl_tpu/ops/pallas/nstep_kernel.py:36 "
          "(R2D2 n-step targets and priorities; not on this path)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
