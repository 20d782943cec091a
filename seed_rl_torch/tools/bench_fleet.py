"""End-to-end remote-fleet data-plane measurement: env frames/s against
the actor count.

The port of ``scripts/bench_fleet.py``. ``tools/bench_batcher.py``
isolates the C++ batcher with a trivial handler; this measures the whole
fleet path on one machine: N ``--run_mode=actor`` processes stepping host
envs, blocking per-step inference over the unix-socket transport, the
native dynamic batcher, the policy on the learner's device, unroll
accumulation and V-trace training (the V-trace kernel,
``csrc/vtrace_kernel.cu``, once an update, in the learner's process) on
the streamed unrolls.

For each actor count it runs ``python -m seed_rl_torch.fleet`` (one
worker, 8 envs an actor, unroll 16, a log line every 5 steps) to a frame
budget. The learner runs on the card (``--device=cpu``
moves it to the CPU); the fleet starts the actors with
``CUDA_VISIBLE_DEVICES=""``. Env frames/s (one inference item an env
frame) are timed from the learner's first logged training step to its
last, on the wall times of its event file (``--logdir``; the console
prints at most one line every 30 s, so the script's window from the
console lines needed runs over 60 s); the mean batcher fill is the frames
at the last logged step over its ``server/total_batches``. The budget must
reach two log calls (10 train steps). One warm-up run of 1 actor
(``--warmup_frames``, 0 to skip) builds the kernels and the batcher
first.

The script's env is MuJoCo's HalfCheetah-v5 (an MLP policy and small
payloads, the reference's QPS workload), which needs gymnasium and
mujoco; ``--env=synthetic_atari_host`` (no package needed: 84x84 frames,
the conv policy) runs where they are absent.

Run:  python -m seed_rl_torch.tools.bench_fleet [frame_budget]
          [actor_counts_csv] [--device=cpu] [--env=mujoco]
          [--warmup_frames=4000]

Defaults 120000 frames, actors 1,2,4. Prints one JSON line a count with
the script's keys (``metric`` ``fleet_env_frames_per_sec``, ``platform``:
the learner's device type, ``actors``, ``envs_per_actor``, ``value``,
``inference_qps``, ``batcher_mean_fill``, ``window_secs``) and ``card``.
"""

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

from seed_rl_torch.tools import _timing

ENVS_PER_ACTOR = 8
STEP_LINE = re.compile(r"step=(\d+) frames=(\d+)")


def run_fleet(actors, envs_per_actor, frames, env="mujoco", unroll=16,
              device="cuda", logdir=None):
    """One fleet run to ``frames``; returns (env frames/s, the window's
    seconds, the mean batcher fill)."""
    from seed_rl_torch.runtime.transport import unique_socket_path
    from seed_rl_torch.utils.metrics import read_scalars

    env_flags = ["--env_name=HalfCheetah-v5"] if env == "mujoco" else []
    cmd = [
        sys.executable, "-m", "seed_rl_torch.fleet",
        "--agent=vtrace", f"--env={env}",
        "--workers=1", f"--actors_per_worker={actors}",
        f"--envs_per_actor={envs_per_actor}",
        f"--logdir={logdir}",
        f"--server_address={unique_socket_path('bench_fleet')}",
        "--",
        *env_flags,
        f"--unroll_length={unroll}",
        f"--total_environment_frames={frames}",
        "--log_every_steps=5",
        f"--device={device}",
    ]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env_vars = dict(os.environ)
    env_vars["PYTHONPATH"] = os.pathsep.join(
        filter(None, [root, env_vars.get("PYTHONPATH")]))
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=root,
                            env=env_vars)
    tail, frames_per_step = [], None
    try:
        for line in proc.stdout:
            tail = (tail + [line])[-20:]
            m = STEP_LINE.search(line)
            if m and frames_per_step is None:
                frames_per_step = int(m.group(2)) / int(m.group(1))
        proc.wait()
    finally:
        if proc.poll() is None:
            proc.terminate()
            proc.wait(timeout=30)
    # The learner's scalars, one record a log call (every 5 steps; the
    # console prints at most one line every 30 s): server/total_batches
    # with its step and wall time.
    logged = [(wall, step, value)
              for path in glob.glob(os.path.join(logdir, "events.out.*"))
              for wall, step, tag, value in read_scalars(path)
              if tag == "server/total_batches"]
    if proc.returncode != 0 or frames_per_step is None or len(logged) < 2:
        raise RuntimeError(
            f"fleet run failed rc={proc.returncode}: {len(logged)} logged "
            "steps (a window needs 2: raise the frame budget)\n"
            + "".join(tail))
    (w0, s0, _), (w1, s1, batches) = min(logged), max(logged)
    elapsed = w1 - w0
    return ((s1 - s0) * frames_per_step / elapsed, elapsed,
            s1 * frames_per_step / batches)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("frame_budget", type=int, nargs="?", default=120_000)
    p.add_argument("actor_counts", nargs="?", default="1,2,4")
    _timing.add_device_flag(p)
    p.add_argument("--env", default="mujoco")
    p.add_argument("--warmup_frames", type=int, default=4000)
    return p.parse_args(argv)


def main(argv=None):
    """Prints and returns one line a count."""
    args = parse_args(argv)
    device = _timing.device_from(args.device)
    card = _timing.card(device)
    logdir = tempfile.mkdtemp(prefix="bench_fleet_")
    kw = dict(env=args.env, device=args.device)
    lines = []
    try:
        if args.warmup_frames:
            run_fleet(1, ENVS_PER_ACTOR, args.warmup_frames,
                      logdir=os.path.join(logdir, "warmup"), **kw)
        for i, actors in enumerate(
                int(x) for x in args.actor_counts.split(",")):
            fps, elapsed, fill = run_fleet(
                actors, ENVS_PER_ACTOR, args.frame_budget,
                logdir=os.path.join(logdir, f"{actors}a_{i + 1}"), **kw)
            line = {"metric": "fleet_env_frames_per_sec",
                    "platform": device.type, "actors": actors,
                    "envs_per_actor": ENVS_PER_ACTOR, "value": fps,
                    # One transport call an env frame (the actors call per
                    # env, concurrently): inference QPS == env frames/s.
                    "inference_qps": fps, "batcher_mean_fill": fill,
                    "window_secs": elapsed, "card": card}
            print(json.dumps(line), flush=True)
            lines.append(line)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    return lines


if __name__ == "__main__":
    main()
