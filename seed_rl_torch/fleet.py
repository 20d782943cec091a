"""Fleet launcher: one learner and W x A actor processes on one machine.

The port's version of ``deploy/run_fleet.py``, launching ``python -m
seed_rl_torch.train``. The reference splits deployment into a cloud driver
that starts one process per node role (gcp/run.py:39-69) and a local tmux
launcher (docker/run.sh); this supervises, on one machine:

  * one learner process (``--run_mode=learner``) that binds the native
    socket inference server and trains on streamed unrolls on the card, and
  * ``workers * actors_per_worker`` actor processes (``--run_mode=actor``),
    each stepping ``envs_per_actor`` host envs with env ids
    ``task * envs_per_actor + i`` (reference common/actor.py:77). Actors
    see no CUDA device (``CUDA_VISIBLE_DEVICES=""``, as the reference's
    docker/run.sh does), so the learner owns the card.

A crashed actor is restarted with backoff (the learner's run_id protocol
absorbs the restart: the old life's in-flight unrolls are dropped); a
learner exit, clean or not, stops the fleet and gives its exit code.

Everything after ``--`` goes verbatim to the learner AND every actor
(gcp/run.py:50-51):

  python -m seed_rl_torch.fleet --agent=vtrace --env=synthetic_atari_host \\
      --workers=2 --actors_per_worker=2 --envs_per_actor=4 \\
      -- --unroll_length=20 --total_environment_frames=1000000
"""

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time


def parse_args(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, passthrough = argv[:split], argv[split + 1:]
    else:
        passthrough = []
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--agent", default="vtrace")
    p.add_argument("--env", default="synthetic_atari_host")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--actors_per_worker", type=int, default=2)
    p.add_argument("--envs_per_actor", type=int, default=4)
    p.add_argument("--server_address", default="",
                   help="unix socket path (at most 107 bytes) or host:port; "
                        "default <logdir>/fleet.sock")
    p.add_argument("--logdir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "seed_rl_torch", "fleet"))
    p.add_argument("--max_actor_restarts", type=int, default=100,
                   help="per-actor restart budget (crash-loop guard)")
    args = p.parse_args(argv)
    args.passthrough = passthrough
    return args


def _learner_cmd(args, num_envs):
    return [
        sys.executable, "-m", "seed_rl_torch.train",
        "--run_mode=learner",
        f"--agent={args.agent}",
        f"--env={args.env}",
        f"--num_envs={num_envs}",
        f"--server_address={args.server_address}",
        f"--logdir={args.logdir}",
    ] + args.passthrough


def _actor_cmd(args, task):
    return [
        sys.executable, "-m", "seed_rl_torch.train",
        "--run_mode=actor",
        f"--agent={args.agent}",
        f"--env={args.env}",
        f"--num_envs={args.envs_per_actor}",
        f"--env_id_offset={task * args.envs_per_actor}",
        f"--server_address={args.server_address}",
        f"--logdir={args.logdir}",
    ] + args.passthrough


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.logdir, exist_ok=True)
    if not args.server_address:
        args.server_address = os.path.join(args.logdir, "fleet.sock")
    num_actors = args.workers * args.actors_per_worker
    num_envs = num_actors * args.envs_per_actor

    env = dict(os.environ)
    actor_env = dict(env, CUDA_VISIBLE_DEVICES="")

    procs: dict = {}
    restarts = [0] * num_actors

    def start_actor(task):
        procs[task] = subprocess.Popen(_actor_cmd(args, task), env=actor_env)

    learner = subprocess.Popen(_learner_cmd(args, num_envs), env=env)
    print(f"fleet: learner pid={learner.pid}; {num_actors} actors x "
          f"{args.envs_per_actor} envs = {num_envs} envs at "
          f"{args.server_address}", flush=True)
    for task in range(num_actors):
        start_actor(task)

    stop = {"requested": False}

    def handle_signal(signum, frame):
        stop["requested"] = True

    signal.signal(signal.SIGTERM, handle_signal)
    signal.signal(signal.SIGINT, handle_signal)

    code = 0
    try:
        while not stop["requested"]:
            rc = learner.poll()
            if rc is not None:
                code = rc
                print(f"fleet: learner exited rc={rc}", flush=True)
                break
            for task, proc in list(procs.items()):
                rc = proc.poll()
                if rc is None:
                    continue
                if rc == 0:
                    # A clean actor exit (e.g. --num_actor_steps reached).
                    del procs[task]
                    continue
                restarts[task] += 1
                if restarts[task] > args.max_actor_restarts:
                    raise RuntimeError(
                        f"actor {task} crash-looped ({restarts[task]} "
                        f"restarts, last rc={rc})")
                delay = min(10.0, 0.5 * restarts[task])
                print(f"fleet: actor {task} died rc={rc}; restart "
                      f"#{restarts[task]} in {delay:.1f}s", flush=True)
                time.sleep(delay)
                start_actor(task)
            time.sleep(1.0)
    finally:
        # Stop exactly the processes this started.
        for proc in [learner] + list(procs.values()):
            if proc.poll() is None:
                proc.terminate()
        deadline = time.time() + 10.0
        for proc in [learner] + list(procs.values()):
            try:
                proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    return code


if __name__ == "__main__":
    sys.exit(main())
