"""Training entry point: ``python -m seed_rl_torch.train --agent=... ...``.

Port of these paths of ``seed_rl_tpu/train.py``, with the same flag names
and defaults, plus ``--device`` (default: the CUDA device; ``--device=cpu``
runs on the CPU):
- ``--agent=vtrace --env={toy,toy_memory}`` (``MLPAndLSTM``), with
  ``--normalize_observations`` if asked (also on the host envs' frames but
  Football's, which it turns into float32 before the net's frame stack);
- ``--agent=vtrace --env={catch,synthetic_atari}`` from 84x84 uint8 frames:
  ``AtariPolicyNet`` (4 stacked frames, LSTM 256) by default, or
  ``ImpalaDeep`` with ``--conv_net=impala_deep`` (``--remat_torso``
  recomputes its torso in the backward pass);
- ``--agent=r2d2 --env=discrete_match`` (``VectorDuelingDQNNet``) and
  ``--agent=r2d2 --env={catch,synthetic_atari}`` (``DuelingLSTMDQNNet``,
  4 stacked frames, LSTM 512): the fused on-device learner with
  prioritized replay;
- ``--agent=ppo`` with each ``--policy_loss``, ``--batch_mode`` and
  ``--advantage_estimator``: on ``toy`` / ``toy_memory`` a 2x64 tanh
  ``ContinuousControlNet`` behind observation normalization (stateless, so
  ``split`` by default), on ``discrete_match`` ``MLPAndLSTM``, on ``catch``
  / ``synthetic_atari`` ``AtariPolicyNet`` with LSTM 256 (recurrent, so
  ``shuffle`` by default); PopArt on the value targets throughout;
- ``--agent=sac`` (the fused on-device learner, uniform replay, polyak
  targets): on ``toy`` / ``toy_memory`` / ``discrete_match`` /
  ``bit_flipping`` ``ActorCriticMLP`` (a one-dimensional head of the
  discrete action on ``discrete_match``), or ``ActorCriticLSTM`` with
  ``--sac_net=lstm``; on ``catch`` / ``catch_continuous``
  ``VisualActorCritic`` over frames; ``--her_window_length`` turns on HER
  (``bit_flipping`` only), and ``--normalize_observations`` works on every
  env (on frames, one statistic per channel);
- every agent on the host envs (``--env={synthetic_atari_host,mujoco,
  atari,dmlab,football}``, stepped on the host by a ``HostBatchedEnv`` of
  ``min(num_envs, 16)`` threads; ``--env_name`` picks the gym env of
  ``mujoco``, ``--game`` the game or level of the others): V-trace and
  PPO through ``host_loop.host_learner_loop``, R2D2 and SAC through
  ``host_offpolicy.host_offpolicy_loop`` with a host-RAM replay under
  ``--replay_ratio`` (default 0.75); ``--pipeline_host_rollouts`` overlaps
  the env stepping with training, and ``--checkpoint_replay`` (with
  ``--logdir``) saves the replay under ``<logdir>/replay`` beside each
  checkpoint and restores it on resume. The nets are the JAX CLI's
  (AtariPolicyNet / DuelingLSTMDQNNet on Atari frames, ImpalaDeep on
  DmLab, GFootball on Football, the vector nets on MuJoCo), but for SAC on
  frames, which takes ``VisualActorCritic`` (the JAX CLI builds an MLP
  there that cannot act). ``atari``, ``dmlab`` and ``football`` need
  ``ale_py``, ``deepmind_lab`` and ``gfootball``, and raise
  ``ImportError`` without them.

Every agent checkpoints and logs as the JAX CLI does:
- ``--logdir``: TensorBoard scalars under it, and checkpoints under
  ``<logdir>/ckpt`` every ``--save_checkpoint_secs`` (the first at once, a
  last one at the end); a run restarted on the same logdir resumes where
  the last checkpoint left it, bitwise as if never stopped;
- ``--init_checkpoint=<logdir>``: with nothing to resume from, warm-start
  the parameters, the optimizer, the statistics and the step from that
  run's latest checkpoint (any ``num_envs``);
- ``--run_mode=eval``: restore, run ``--eval_episodes`` episodes with the
  deterministic policy step, print one JSON line with
  ``eval/restored_step``;
- ``--run_mode=profile``: warm the replay up (R2D2, SAC), make one warm
  call, then trace ``--profile_calls`` calls of ``--steps_per_call`` steps
  with ``torch.profiler`` into ``<logdir or $TMPDIR/seed_rl_torch>/profile
  /trace.json`` (Chrome format) and print one JSON line;
- ``--agent=ppo`` only: ``--num_checkpoints``, ``--num_saved_models``
  (exports to ``<logdir>/saved_models/<frames>``) and ``--num_snapshots``
  (in-memory, on ``learner.snapshots``) at linspace frame marks.

The remote-actor runtime (``runtime/``, ``remote.py``), on the host envs:
- ``--run_mode=learner`` serves batched inference at ``--server_address``
  (a unix socket path, or ``host:port`` for fleets across machines) and
  trains on the unrolls that actors stream to it: V-trace and PPO one
  unroll per env per update, R2D2 and SAC through the host-RAM replay
  under ``--replay_ratio`` (insertion batches of ``batch_size /
  replay_ratio`` unrolls; R2D2's eval envs, the last ``--num_eval_envs``
  ids, act with the eval epsilon and stay out of the replay).
  ``--num_envs`` is the whole fleet's; ``--inference_batch_size`` (0: half
  the envs) is the batch the server fills or flushes after 50 ms;
- ``--run_mode=actor`` steps ``--num_envs`` host envs with global ids from
  ``--env_id_offset`` against that server (for ``--num_actor_steps``
  steps, 0 = until stopped), reconnecting when the learner goes away. It
  never touches a CUDA device. It prints JSON lines: one once SIGTERM
  stops it cleanly, one per episode it completes, and one when it stops,
  with its timings and whether CUDA was initialised.
``python -m seed_rl_torch.fleet`` starts a learner and its actors on one
machine.

Data parallelism (``parallel/``): the four device learners train on
``--num_replicas`` ranks (default: every local CUDA device; one with
``--device=cpu``), ``cuda:r`` over NCCL or CPU ranks over gloo. Each rank
steps its share of ``--num_envs`` and stores its share of the replay; the
result equals the one-rank run's. This process is rank 0: it alone prints,
writes the scalars and writes checkpoints (in the one-rank layout, so a
run resumes on any number of ranks). More than one replica asked for on a
host env or outside ``--run_mode=train`` raises ``ValueError`` (the JAX
CLI ignores the flag there), as do more ranks than cards.

``--agent_module=<file or dotted module>`` recomposes the agent stack
before the learner is built, in every run mode: its ``configure(args, env,
components)`` takes the JAX CLI's components for the agent (see
``_apply_agent_module``; ``seed_rl_torch/examples/custom_ppo_composition.py``
is an example). Observation normalization under R2D2 and PPO (which the
JAX CLI ignores) and under V-trace on the device frame envs (where the JAX
CLI's rollout fails) and on Football (whose net bit-unpacks the frames),
and the agent/env pairs the JAX CLI cannot run, raise
``NotImplementedError`` rather than being ignored.
Where the JAX CLI accepts a flag and ignores it, or takes one it cannot
use, this one raises ``ValueError``:
``--conv_net=atari``, ``--conv_net=impala_deep`` and ``--remat_torso``
where no conv net reads them, a ``--lambda_`` other than its default under
``--agent=vtrace``, the action-point counts outside ``--agent=ppo`` on a
device env, ``--train_batches_per_step``, ``--update_target_every_n_step``
and ``--sac_net=lstm`` on frames under ``--agent=sac``, HER on any env but
``bit_flipping`` or with windows shorter than ``unroll_length + 1``,
``--replay_ratio`` and ``--checkpoint_replay`` outside R2D2 and SAC on a
host env (and ``--checkpoint_replay`` without ``--logdir``),
``--pipeline_host_rollouts`` on a device env or in the remote modes,
``--train_batches_per_step`` under R2D2 on a host env, ``--run_mode=profile``
on a host env (the JAX CLI asserts), the remote modes' flags outside them,
and R2D2 on an env without discrete actions. The remote modes on a device env raise
``NotImplementedError`` (the JAX CLI's actor asserts a host env; its
learner takes a device env's specs).

Examples (the README's quick-start configs):
  python -m seed_rl_torch.train --agent=vtrace --env=toy \
      --num_envs=64 --unroll_length=10 --total_environment_frames=200000
  python -m seed_rl_torch.train --agent=r2d2 --env=discrete_match \
      --num_envs=32 --unroll_length=10 --burn_in=4 \
      --replay_buffer_min_size=100 --total_environment_frames=50000
  python -m seed_rl_torch.train --agent=vtrace --env=catch \
      --num_envs=256 --unroll_length=20 --entropy_cost=0.01 \
      --learning_rate=1e-3 --total_environment_frames=3000000
  python -m seed_rl_torch.train --agent=ppo --env=toy \
      --num_envs=128 --unroll_length=16 --epochs_per_step=10 \
      --batches_per_step=32 --learning_rate=3e-4 --clip_norm=0.5
  python -m seed_rl_torch.train --agent=sac --env=bit_flipping \
      --sac_net=lstm --her_window_length=16 --unroll_length=2 \
      --num_envs=256 --batch_size=256 --replay_buffer_size=4096
  python -m seed_rl_torch.train --agent=vtrace --env=catch \
      --num_envs=256 --unroll_length=20 --logdir=/path/to/run \
      --run_mode=eval --eval_episodes=256
  python -m seed_rl_torch.train --agent=r2d2 --env=synthetic_atari_host \
      --num_envs=64 --unroll_length=80 --burn_in=40 --replay_ratio=0.75 \
      --pipeline_host_rollouts --logdir=/path/to/run --checkpoint_replay
  python -m seed_rl_torch.train --run_mode=learner --agent=vtrace \
      --env=synthetic_atari_host --num_envs=64 --server_address=/tmp/l.sock
  python -m seed_rl_torch.train --run_mode=actor --agent=vtrace \
      --env=synthetic_atari_host --num_envs=32 --env_id_offset=32 \
      --server_address=/tmp/l.sock
"""

import argparse
import dataclasses
import functools
import json
import math
import os
import sys
import tempfile
import time

import torch

from seed_rl_torch.device import resolve_device

# The JAX CLI's choices, so every spelling it accepts is recognised here and
# refused by name where the port does not run it.
AGENTS = ["vtrace", "ppo", "r2d2", "sac"]
ENVS = [
    "toy", "toy_memory", "discrete_match", "bit_flipping", "synthetic_atari",
    "synthetic_atari_host", "catch", "catch_continuous", "mujoco", "atari",
    "dmlab", "football",
]
RUN_MODES = ["train", "eval", "profile", "actor", "learner"]
# Envs stepped on the host (HostBatchedEnv); every agent takes them.
HOST_ENVS = ("synthetic_atari_host", "mujoco", "atari", "dmlab", "football")
# agent -> the envs it is ported for.
PORTED = {
    "vtrace": ("toy", "toy_memory", "catch", "synthetic_atari") + HOST_ENVS,
    "r2d2": ("discrete_match", "catch", "synthetic_atari") + HOST_ENVS,
    "ppo": ("toy", "toy_memory", "discrete_match", "catch",
            "synthetic_atari") + HOST_ENVS,
    "sac": ("toy", "toy_memory", "discrete_match", "bit_flipping", "catch",
            "catch_continuous") + HOST_ENVS,
}
# Envs of Atari-shaped frames: AtariPolicyNet, DuelingLSTMDQNNet, and
# ImpalaDeep under --conv_net=impala_deep.
ATARI_FRAME_ENVS = ("catch", "synthetic_atari", "synthetic_atari_host",
                    "atari")
# Envs whose observations are frames.
PIXEL_ENVS = ATARI_FRAME_ENVS + ("catch_continuous", "dmlab", "football")
LAMBDA_DEFAULT = 0.95
# The JAX CLI's --replay_ratio default (the reference R2D2's).
REPLAY_RATIO_DEFAULT = 0.75
# Reseeds the envs' generator for --run_mode=eval (the JAX CLI's eval key).
EVAL_SEED = 1234
# The remote modes' flags: name -> default (outside the modes, the JAX CLI
# ignores them).
REMOTE_FLAGS = {"env_id_offset": 0, "num_actor_steps": 0,
                "inference_batch_size": 0}
# The JAX CLI's defaults of flags its SAC branch never reads.
TRAIN_BATCHES_PER_STEP_DEFAULT = 1
UPDATE_TARGET_EVERY_N_STEP_DEFAULT = 2500


def default_server_address() -> str:
    return os.path.join(tempfile.gettempdir(), "seed_rl_torch.sock")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--agent", required=True, choices=AGENTS)
    p.add_argument("--run_mode", default="train", choices=RUN_MODES,
                   help="eval = restore from --logdir (or --init_checkpoint)"
                        " and evaluate the deterministic policy; profile = "
                        "trace --profile_calls calls with torch.profiler; "
                        "learner = serve inference at --server_address and "
                        "train on the unrolls actors stream; actor = step "
                        "host envs against that server")
    p.add_argument("--server_address", default=default_server_address(),
                   help="actor and learner modes: a unix socket path (at "
                        "most 107 bytes), or host:port / tcp://host:port")
    p.add_argument("--env_id_offset", type=int, default=0,
                   help="actor mode: the global id of this process's first "
                        "env (the reference's task * env_batch_size)")
    p.add_argument("--num_actor_steps", type=int, default=0,
                   help="actor mode: stop after N env steps (0 = run until "
                        "stopped)")
    p.add_argument("--inference_batch_size", type=int, default=0,
                   help="learner mode: the server's batch; 0 = the "
                        "reference's auto-tune, max(1, num_envs / 2)")
    p.add_argument("--env", required=True, choices=ENVS,
                   help="synthetic_atari_host = Atari-shaped frames from "
                        "host-process envs (the host data path without "
                        "ale_py)")
    p.add_argument("--env_name", default="HalfCheetah-v5",
                   help="the gym env of --env=mujoco")
    p.add_argument("--game", default="Pong",
                   help="the game or level of --env={atari,dmlab,football}")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA device")
    p.add_argument("--logdir", default=None,
                   help="TensorBoard scalars and checkpoints (<logdir>/ckpt)"
                        "; a run on a logdir that holds one resumes it")
    p.add_argument("--total_environment_frames",
                   type=lambda s: int(float(s)), default=1_000_000)
    p.add_argument("--num_envs", type=int, default=64)
    p.add_argument("--unroll_length", type=int, default=20)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--lr_decay_multiplier", type=float, default=1.0,
                   help="linear lr decay to lr_decay_multiplier*lr over "
                        "the frame budget (1.0 = constant lr)")
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--clip_norm", type=float, default=40.0)
    p.add_argument("--discounting", type=float, default=0.99)
    p.add_argument("--entropy_cost", type=float, default=2.5e-4)
    p.add_argument("--save_checkpoint_secs", type=float, default=1800)
    p.add_argument("--init_checkpoint", default=None,
                   help="a logdir to warm-start from when --logdir holds "
                        "no checkpoint")
    p.add_argument("--checkpoint_replay", action="store_true",
                   help="R2D2 and SAC on host envs: save the host-RAM "
                        "replay under <logdir>/replay beside each "
                        "checkpoint and restore it on resume")
    p.add_argument("--eval_episodes", type=int, default=32)
    p.add_argument("--profile_calls", type=int, default=5,
                   help="train_many calls traced by --run_mode=profile")
    p.add_argument("--steps_per_call", type=int, default=10)
    p.add_argument("--log_every_steps", type=int, default=20)
    p.add_argument("--normalize_observations", action="store_true",
                   help="streaming mean/std observation normalization "
                        "(--agent=vtrace or sac; on frames one statistic "
                        "per channel; V-trace on the host envs' frames, "
                        "not the device ones)")
    p.add_argument("--num_replicas", type=int, default=0,
                   help="data-parallel ranks of the device learners: 0 = "
                        "all local CUDA devices (1 with --device=cpu); N > 1 "
                        "spawns N ranks, cuda:r over NCCL or, with "
                        "--device=cpu, CPU ranks over gloo")
    p.add_argument("--conv_net", default="auto",
                   choices=["auto", "atari", "impala_deep"],
                   help="conv torso for pixel envs under --agent=vtrace: "
                        "auto = AtariPolicyNet (Nature-DQN torso, 4 stacked "
                        "frames, LSTM 256); impala_deep = the DmLab-class "
                        "deep resnet (ImpalaDeep); atari is refused (it "
                        "selects nothing in the JAX CLI either)")
    p.add_argument("--remat_torso", action="store_true",
                   help="recompute the ImpalaDeep torso in the backward "
                        "pass instead of storing its activations")
    p.add_argument("--debug_asserts", action="store_true",
                   help="enable the replay's contract checks (priority "
                        "validity, ring bounds); each check waits for the "
                        "device, so they are off by default")
    # R2D2.
    p.add_argument("--burn_in", type=int, default=40)
    p.add_argument("--n_steps", type=int, default=5)
    p.add_argument("--target", default="nstep", choices=["nstep", "retrace"],
                   help="R2D2 target estimator: n-step Bellman or "
                        "Retrace(lambda) clipped-trace targets")
    p.add_argument("--retrace_lambda", type=float, default=0.95)
    p.add_argument("--replay_buffer_size",
                   type=lambda s: int(float(s)), default=10_000,
                   help="unrolls (R2D2) / windows (SAC): kept on the device "
                        "for device envs, in host RAM for host envs")
    p.add_argument("--replay_buffer_min_size", type=int, default=500,
                   help="buffer fill before training starts")
    p.add_argument("--replay_ratio", type=float, default=None,
                   help="R2D2 and SAC on host envs: expected times each "
                        "stored item is trained on (default "
                        f"{REPLAY_RATIO_DEFAULT})")
    p.add_argument("--pipeline_host_rollouts", action="store_true",
                   help="host envs: step the envs beside training, with "
                        "one-update-stale behaviour parameters")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--update_target_every_n_step", type=int,
                   default=UPDATE_TARGET_EVERY_N_STEP_DEFAULT,
                   help="R2D2's hard target sync, in train steps")
    p.add_argument("--train_batches_per_step", type=int,
                   default=TRAIN_BATCHES_PER_STEP_DEFAULT,
                   help="R2D2 optimization batches per rollout cycle")
    p.add_argument("--num_eval_envs", type=int, default=0)
    # SAC.
    p.add_argument("--her_window_length", type=int, default=0,
                   help="HER window (rollout unroll) length; 0 = no HER")
    p.add_argument("--polyak", type=float, default=0.9)
    p.add_argument("--sac_entropy_cost", type=float, default=0.01,
                   help="initial entropy cost alpha")
    p.add_argument("--target_entropy", default=None,
                   help="if set, alpha is adjusted toward this policy "
                        "entropy; 'auto' = -dim of the action space")
    p.add_argument("--entropy_cost_adjustment_speed", type=float,
                   default=1.0)
    p.add_argument("--bootstrap_net", default="v", choices=["v", "q"],
                   help="bootstrap from the target V, or the target min-Q "
                        "of a fresh action plus alpha * entropy")
    p.add_argument("--sac_net", default="mlp", choices=["mlp", "lstm"],
                   help="mlp = ActorCriticMLP; lstm = ActorCriticLSTM (LSTM "
                        "+ feed-forward branch); frames always take "
                        "VisualActorCritic")
    # The on-policy family (--agent=ppo).
    p.add_argument("--lambda_", type=float, default=LAMBDA_DEFAULT,
                   help="GAE / V-trace lambda of --advantage_estimator "
                        "(--agent=ppo)")
    p.add_argument("--epochs_per_step", type=int, default=10)
    p.add_argument("--batch_mode", default=None,
                   choices=["repeat", "shuffle", "split",
                            "split_with_advantage_recomputation"],
                   help="default: split for stateless nets, shuffle for "
                        "recurrent ones")
    p.add_argument("--batches_per_step", type=int, default=32)
    p.add_argument("--policy_loss", default="ppo",
                   choices=["ppo", "vmpo", "awr", "pg", "vtrace"])
    p.add_argument("--ppo_epsilon", type=float, default=0.2)
    p.add_argument("--awr_beta", type=float, default=1.0)
    p.add_argument("--awr_w_max", type=float, default=20.0)
    p.add_argument("--vmpo_e_n", type=float, default=0.1,
                   help="V-MPO temperature constraint threshold")
    p.add_argument("--ppo_entropy_cost", type=float, default=0.0,
                   help="entropy bonus in the on-policy regularizer")
    p.add_argument("--advantage_estimator", default="gae",
                   choices=["gae", "vtrace"])
    p.add_argument("--num_checkpoints", type=int, default=0)
    p.add_argument("--num_saved_models", type=int, default=0)
    p.add_argument("--num_snapshots", type=int, default=0)
    p.add_argument("--agent_module", default=None,
                   help="path to a Python file (or a dotted module name) "
                        "whose configure(args, env, components) recomposes "
                        "the agent stack (net, distribution, agent, loss, "
                        "config, optimizer) before the learner is built; see "
                        "seed_rl_torch/examples/custom_ppo_composition.py")
    return p.parse_args(argv)


def _apply_agent_module(args, env, components: dict) -> dict:
    """The free-composition hook: loads ``--agent_module`` (a file path or
    a dotted module name) and calls its ``configure(args, env,
    components)``; what it returns replaces ``components`` (None keeps its
    changes in place).

    ``components`` holds the JAX CLI's keys for the agent: ``net``,
    ``dist``, ``agent``, ``config`` and ``optimizer`` for V-trace and SAC,
    the same and ``loss`` for PPO, and ``net``, ``agent``, ``config`` and
    ``optimizer`` for R2D2. Where the JAX CLI passes an optax transform,
    ``optimizer`` here is a factory ``params -> optimizer`` (the CLI's is a
    ``functools.partial`` of ``optim.ClippedAdam``, whose ``learning_rate``
    may be a schedule and which takes a ``weight_decay``); the learner calls
    it on its parameters.
    """
    if not args.agent_module:
        return components
    import importlib
    import importlib.util

    if os.path.exists(args.agent_module):
        spec = importlib.util.spec_from_file_location(
            "seed_rl_torch_agent_module", args.agent_module)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(args.agent_module)
    configure = getattr(module, "configure", None)
    if configure is None:
        raise AttributeError(f"--agent_module={args.agent_module} must "
                             "define configure(args, env, components)")
    result = configure(args, env, components)
    return components if result is None else result


def _refuse_unported(args):
    def refuse(what):
        raise NotImplementedError(
            f"{what} is not ported to seed_rl_torch yet; use "
            "python -m seed_rl_tpu.train (see ROADMAP.md queue A)"
        )

    if args.agent not in PORTED:
        refuse(f"--agent={args.agent}")
    if args.env not in PORTED[args.agent]:
        refuse(f"--env={args.env} with --agent={args.agent}")
    if args.normalize_observations and args.agent not in ("vtrace", "sac"):
        raise NotImplementedError(
            f"--normalize_observations is not ported to --agent="
            f"{args.agent}: the JAX CLI ignores it there")
    if (args.normalize_observations and args.agent == "vtrace"
            and args.env in PIXEL_ENVS and args.env not in HOST_ENVS):
        raise NotImplementedError(
            f"--normalize_observations with --agent=vtrace on the device "
            f"frame env --env={args.env} is not ported: the JAX CLI's "
            "rollout fails there (its float32 frame stack cannot replace "
            "the uint8 one in the rollout's carry)")
    if (args.normalize_observations and args.agent == "vtrace"
            and args.env == "football"):
        raise NotImplementedError(
            "--normalize_observations with --agent=vtrace --env=football is "
            "not ported: the JAX CLI cannot run it (GFootball bit-unpacks "
            "its packed uint16 frames, which the normalization has turned "
            "into floats)")
    host = args.env in HOST_ENVS
    _refuse_remote_flags(args, host)
    for flag in ("num_checkpoints", "num_saved_models", "num_snapshots"):
        if getattr(args, flag) and (args.agent != "ppo" or host):
            raise ValueError(f"--{flag} is read by --agent=ppo on a device "
                             "env only (the JAX CLI ignores it elsewhere)")
    _refuse_host_flags(args, host)
    if args.conv_net == "atari":
        raise ValueError(
            "--conv_net=atari selects nothing in the JAX CLI; AtariPolicyNet "
            "is --conv_net=auto on a pixel env")
    conv = args.agent == "vtrace" and args.env in ATARI_FRAME_ENVS
    if args.conv_net == "impala_deep" and not conv:
        raise ValueError(
            "--conv_net=impala_deep needs --agent=vtrace and Atari-shaped "
            f"frames ({', '.join(ATARI_FRAME_ENVS)})")
    impala_deep = args.conv_net == "impala_deep" or (
        args.env == "dmlab" and args.agent in ("vtrace", "ppo"))
    if args.remat_torso and not impala_deep:
        raise ValueError("--remat_torso needs ImpalaDeep: "
                         "--conv_net=impala_deep, or V-trace or PPO on dmlab")
    if args.agent == "vtrace" and args.lambda_ != LAMBDA_DEFAULT:
        raise ValueError("--lambda_ is read by --agent=ppo only; V-trace "
                         "keeps lambda 1 (the JAX CLI ignores the flag)")
    if args.agent == "sac":
        _refuse_sac_flags(args)


def _refuse_remote_flags(args, host):
    remote = args.run_mode in ("actor", "learner")
    if remote and not host:
        raise NotImplementedError(
            f"--run_mode={args.run_mode} on the device env --env={args.env} "
            "is not ported: the remote runtime serves host envs "
            f"({', '.join(HOST_ENVS)}); the JAX CLI's actor asserts one, "
            "its learner takes a device env's specs only")
    if remote and args.pipeline_host_rollouts:
        raise ValueError("--pipeline_host_rollouts is not read in the remote "
                         "modes: the actors step the envs")
    flags = dict(REMOTE_FLAGS, server_address=default_server_address())
    for flag, default in flags.items():
        if getattr(args, flag) != default and not remote:
            raise ValueError(f"--{flag} is read by --run_mode=actor and "
                             "learner only")


def _refuse_host_flags(args, host):
    offpolicy = host and args.agent in ("r2d2", "sac")
    for flag in ("replay_ratio", "checkpoint_replay"):
        if getattr(args, flag) not in (None, False) and not offpolicy:
            raise ValueError(f"--{flag} is read by R2D2 and SAC on a host env "
                             f"only ({', '.join(HOST_ENVS)}); the JAX CLI "
                             "ignores it elsewhere")
    if args.checkpoint_replay and not args.logdir:
        raise ValueError("--checkpoint_replay requires --logdir")
    if args.pipeline_host_rollouts and not host:
        raise ValueError("--pipeline_host_rollouts is read on a host env "
                         f"only ({', '.join(HOST_ENVS)})")
    if not host:
        return
    if args.run_mode == "profile":
        raise ValueError("--run_mode=profile traces the on-device engine; "
                         "the JAX CLI refuses it on host envs too")
    if (args.agent == "r2d2"
            and args.train_batches_per_step != TRAIN_BATCHES_PER_STEP_DEFAULT):
        raise ValueError("--train_batches_per_step is not read on a host "
                         "env: --replay_ratio sets the batches a cycle")
    if args.agent == "sac" and args.env == "football":
        raise ValueError("no SAC net reads Football's bit-packed frames")


def _refuse_sac_flags(args):
    for flag, default in (
            ("train_batches_per_step", TRAIN_BATCHES_PER_STEP_DEFAULT),
            ("update_target_every_n_step",
             UPDATE_TARGET_EVERY_N_STEP_DEFAULT)):
        if getattr(args, flag) != default:
            raise ValueError(
                f"--{flag} is not read under --agent=sac: the JAX CLI runs "
                "one batch a step with a polyak move every batch")
    if args.sac_net == "lstm" and args.env in PIXEL_ENVS:
        raise ValueError("--sac_net=lstm selects nothing on frames: they "
                         "take VisualActorCritic")
    if args.her_window_length:
        if args.env != "bit_flipping":
            raise ValueError("--her_window_length (HER) needs "
                             "--env=bit_flipping, whose reward it recomputes")
        if args.her_window_length < args.unroll_length + 1:
            raise ValueError(
                f"--her_window_length={args.her_window_length} cannot hold "
                f"an unroll of --unroll_length={args.unroll_length} + 1")


def _refuse_replicas(args):
    """Only the device learners run sharded: more than one rank asked for
    on a host env or in the eval, profile, learner or actor modes raises
    (the JAX CLI ignores the flag there)."""
    if args.num_replicas < 0:
        raise ValueError("--num_replicas must be >= 0")
    if args.num_replicas > 1:
        if args.env in HOST_ENVS:
            raise ValueError(f"--num_replicas={args.num_replicas}: the host "
                             f"env --env={args.env} runs on one device")
        if args.run_mode != "train":
            raise ValueError(f"--num_replicas={args.num_replicas}: "
                             f"--run_mode={args.run_mode} runs on one device")


def num_replicas(args, device) -> int:
    """The data-parallel ranks of a run: ``--num_replicas``, or by default
    every local CUDA device (one on the CPU, on a host env and outside
    ``--run_mode=train``). More ranks than cards raise, as do CPU ranks
    without gloo."""
    _refuse_replicas(args)
    if args.env in HOST_ENVS or args.run_mode != "train":
        return 1
    replicas = args.num_replicas or (
        torch.cuda.device_count() if device.type == "cuda" else 1)
    if replicas > 1 and device.type == "cuda" and (
            replicas > torch.cuda.device_count()):
        raise ValueError(f"--num_replicas={replicas} needs as many CUDA "
                         f"devices; there are {torch.cuda.device_count()}")
    if replicas > 1 and device.type == "cpu" and not (
            torch.distributed.is_available()
            and torch.distributed.is_gloo_available()):
        raise ValueError(f"--num_replicas={replicas} with --device=cpu needs "
                         "torch.distributed's gloo backend, which this torch "
                         "build lacks")
    return replicas


def _host_env(args, i: int):
    """Env ``i`` of a host fleet (the JAX CLI's env table)."""
    if args.env == "synthetic_atari_host":
        from seed_rl_torch.envs.synthetic import SyntheticAtariGymEnv

        return SyntheticAtariGymEnv()
    if args.env == "mujoco":
        from seed_rl_torch.envs import mujoco

        return mujoco.create_environment(args.env_name)
    if args.env == "atari":
        from seed_rl_torch.envs import atari

        return atari.create_environment(args.game, task=i)
    if args.env == "dmlab":
        from seed_rl_torch.envs import dmlab

        return dmlab.create_environment(args.game, task=i)
    from seed_rl_torch.envs import football

    return football.create_environment(args.game)


def make_env(args, device, mesh=None):
    """The env and whether it steps on the host: a ``BatchedEnv`` on
    ``device`` (this rank's share of it with a ``mesh``), or a
    ``HostBatchedEnv`` of ``min(num_envs, 16)`` threads."""
    from seed_rl_torch import envs

    if args.env in HOST_ENVS:
        return envs.HostBatchedEnv(functools.partial(_host_env, args),
                                   args.num_envs,
                                   num_threads=min(args.num_envs, 16)), True
    env = {
        "toy": envs.ToyEnv,
        "toy_memory": envs.ToyMemoryEnv,
        "discrete_match": envs.DiscreteMatchEnv,
        "bit_flipping": envs.BitFlippingEnv,
        "catch": envs.CatchEnv,
        "catch_continuous": envs.ContinuousCatchEnv,
        "synthetic_atari": envs.SyntheticAtariEnv,
    }[args.env]()
    return envs.BatchedEnv(env, args.num_envs, device=device, seed=0,
                           mesh=mesh), False


def main(argv=None, mesh=None):
    """Trains, evaluates, profiles or serves actors (``--run_mode``);
    returns (learner, train state, metrics): the last call's metrics,
    eval's or profile's. An actor returns the env steps it ran.

    With more than one replica (``--num_replicas``) the training runs on
    that many ranks (``parallel.spawn``): this process is rank 0, and main
    returns its result; the learner is then a ``DistributedLearner``. A
    caller that has made its own ``mesh`` (a rank of its own process
    group) passes it, and main runs that rank.
    """
    args = parse_args(argv)
    _refuse_unported(args)
    _refuse_replicas(args)
    if args.run_mode == "actor":
        return _run_actor(args)
    device = resolve_device(args.device)
    if mesh is None:
        replicas = num_replicas(args, device)
        if replicas > 1:
            from seed_rl_torch import parallel

            threads = (max(1, torch.get_num_threads() // replicas)
                       if device.type == "cpu" else None)
            return parallel.spawn(_replica_main, replicas, device,
                                  args=(list(argv) if argv is not None
                                        else sys.argv[1:],),
                                  threads=threads)[0]
    else:
        if args.num_replicas not in (0, mesh.size):
            raise ValueError(f"--num_replicas={args.num_replicas} on a mesh "
                             f"of {mesh.size}")
        if device.type != mesh.device.type:
            raise ValueError(f"--device={args.device or 'cuda'} asks for "
                             f"{device.type}; this rank of the mesh runs on "
                             f"{mesh.device}")
        device = mesh.device

    from seed_rl_torch.utils import debug_asserts

    debug_asserts.enable(args.debug_asserts)
    env, host = make_env(args, device, mesh)
    try:
        return _run(args, env, host, device, mesh)
    finally:
        if host:
            env.close()


def _replica_main(mesh, argv):
    """One rank of ``main``'s spawned run; ranks above 0 return nothing
    (their learner stays in their process)."""
    result = main(argv, mesh=mesh)
    return result if mesh.rank == 0 else None


def _optimizer_updates(args, host):
    """The optimizer updates of the frame budget, for the linear lr decay
    (the reference's PolynomialDecay with power 1): one per V-trace or SAC
    step (whose rollouts span the HER window), train_batches_per_step per
    R2D2 step, epochs_per_step x batches_per_step per PPO step, and on a
    host env the off-policy loop's owed batches, replay_ratio x training
    envs / batch_size a cycle (at least one); a remote learner's cycle
    inserts an insertion batch."""
    if args.run_mode == "learner" and args.agent in ("r2d2", "sac"):
        insertion = _insertion_batch(args)
        cycles = max(1, args.total_environment_frames
                     // (insertion * args.unroll_length))
        per_cycle = _replay_ratio(args) * insertion / args.batch_size
        return int(cycles * max(1.0, per_cycle))
    unroll = args.unroll_length
    if args.agent == "sac" and args.her_window_length:
        unroll = args.her_window_length
    frames_per_rollout = max(1, args.num_envs * unroll)
    rollouts = max(1, args.total_environment_frames // frames_per_rollout)
    if host and args.agent in ("r2d2", "sac"):
        training = args.num_envs - (
            args.num_eval_envs if args.agent == "r2d2" else 0)
        per_cycle = _replay_ratio(args) * training / args.batch_size
        return int(rollouts * max(1.0, per_cycle))
    if args.agent == "r2d2":
        return rollouts * max(1, args.train_batches_per_step)
    if args.agent == "ppo":
        return rollouts * max(1, args.epochs_per_step * args.batches_per_step)
    return rollouts


def _replay_ratio(args):
    return (REPLAY_RATIO_DEFAULT if args.replay_ratio is None
            else args.replay_ratio)


def _insertion_batch(args):
    """Unrolls a remote off-policy learner inserts a cycle (the
    reference's insertion_batch, r2d2 learner.py:113-117)."""
    return max(1, int(round(args.batch_size / _replay_ratio(args))))


def _run_actor(args):
    """``--run_mode=actor``: steps host envs against the learner at
    ``--server_address`` (``remote.actor_main``). Touches no CUDA device."""
    from seed_rl_torch.remote import actor_main

    return actor_main(lambda: make_env(args, None)[0], args.server_address,
                      num_steps=args.num_actor_steps or None,
                      env_id_offset=args.env_id_offset)

def _run(args, env, host, device, mesh=None):
    from seed_rl_torch import optim
    from seed_rl_torch.utils.checkpoint import CheckpointManager
    from seed_rl_torch.utils.metrics import MetricsLogger

    learning_rate = args.learning_rate
    if args.lr_decay_multiplier != 1.0:
        learning_rate = optim.linear_schedule(
            args.learning_rate, args.lr_decay_multiplier * args.learning_rate,
            _optimizer_updates(args, host))
    optimizer = functools.partial(
        optim.ClippedAdam,
        learning_rate=learning_rate,
        clip_norm=args.clip_norm,
        b1=args.adam_beta1,
        eps=args.adam_epsilon,
    )
    build = {"r2d2": _r2d2_learner, "ppo": _ppo_learner,
             "sac": _sac_learner, "vtrace": _vtrace_learner}[args.agent]
    learner, loop = build(args, env, host, optimizer, device)
    if mesh is not None:
        from seed_rl_torch.parallel import DistributedLearner

        learner = DistributedLearner(learner, mesh)
    checkpoint = CheckpointManager(
        args.logdir,
        save_checkpoint_secs=args.save_checkpoint_secs,
        init_checkpoint=args.init_checkpoint,
    )
    if args.run_mode == "eval":
        return _eval(args, learner, checkpoint, env, host, device)
    if args.run_mode == "profile":
        return _profile(args, learner)
    # Rank 0 alone prints and writes the scalars; every rank takes the log
    # branch, whose episode window is a collective.
    logger = (MetricsLogger(args.logdir) if mesh is None or mesh.rank == 0
              else MetricsLogger(None, console_every_secs=float("inf")))
    try:
        state, metrics = loop(
            learner,
            args.total_environment_frames,
            logger=logger,
            checkpoint=checkpoint,
            log_every_steps=args.log_every_steps,
            steps_per_call=args.steps_per_call,
        )
    finally:
        logger.close()
        checkpoint.close()
    return learner, state, metrics


def _host_loop(engine, replay=None, replay_ratio=None, min_size=None,
               replay_dir=None, pipeline=False):
    """A host-env training loop with the device loops' signature:
    ``host_learner_loop`` without a replay, ``host_offpolicy_loop`` with
    one (a log line every ``log_every_steps`` cycles)."""
    def loop(learner, total_environment_frames, logger=None, checkpoint=None,
             log_every_steps=10, steps_per_call=1):
        del steps_per_call  # the host loops take one cycle at a time
        if replay is None:
            from seed_rl_torch.host_loop import host_learner_loop

            return host_learner_loop(
                learner, engine, total_environment_frames, logger=logger,
                checkpoint=checkpoint, log_every_steps=log_every_steps,
                pipeline=pipeline)
        from seed_rl_torch.host_offpolicy import host_offpolicy_loop

        return host_offpolicy_loop(
            learner, engine, replay, total_environment_frames,
            replay_ratio=replay_ratio, replay_buffer_min_size=min_size,
            logger=logger, checkpoint=checkpoint,
            log_every_cycles=log_every_steps, pipeline=pipeline,
            replay_dir=replay_dir)

    return loop


def _offpolicy_host_loop(args, engine, importance_sampling_exponent, device):
    from seed_rl_torch.replay_host import HostReplayBuffer

    replay = HostReplayBuffer(args.replay_buffer_size,
                              importance_sampling_exponent, device=device)
    replay_dir = (os.path.join(os.path.abspath(args.logdir), "replay")
                  if args.checkpoint_replay else None)
    return _host_loop(engine, replay, _replay_ratio(args),
                      args.replay_buffer_min_size, replay_dir,
                      args.pipeline_host_rollouts)


def _eval(args, learner, checkpoint, env, host, device):
    """``--run_mode=eval``: restore, then deterministic evaluation on the
    learner's envs (host envs reset with seed 0, as the JAX CLI's); prints
    one JSON line."""
    from seed_rl_torch.evaluation import run_eval

    state = checkpoint.restore_or(learner, learner.init())
    metrics = run_eval(env, learner.agent, args.eval_episodes,
                       unroll_length=args.unroll_length, seed=EVAL_SEED,
                       host=host, device=device)
    metrics["eval/restored_step"] = state.step
    print(json.dumps(metrics), flush=True)
    return learner, state, metrics


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(args, learner):
    """``--run_mode=profile``: after the replay's warm-up (R2D2, SAC) and
    one warm call, trace ``--profile_calls`` calls with ``torch.profiler``
    (the CPU and, on the card, CUDA) into a Chrome trace; prints one JSON
    line with the traced calls' env frames/s."""
    from torch.profiler import ProfilerActivity, profile

    state = learner.init()
    if hasattr(learner, "warmup_step"):  # replay learners
        while (state.replay.num_inserted
               < learner.config.replay_buffer_min_size):
            state = learner.warmup_step(state)
    state, _ = learner.train_many(state, args.steps_per_call)
    _synchronize(learner.device)
    activities = [ProfilerActivity.CPU]
    if learner.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    start = time.perf_counter()
    with profile(activities=activities) as prof:
        for _ in range(args.profile_calls):
            state, _ = learner.train_many(state, args.steps_per_call)
        _synchronize(learner.device)
    seconds = time.perf_counter() - start
    outdir = os.path.join(
        args.logdir or os.path.join(tempfile.gettempdir(), "seed_rl_torch"),
        "profile")
    os.makedirs(outdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))
    frames = args.profile_calls * args.steps_per_call * learner.frames_per_step
    result = {
        "profile_dir": outdir,
        "frames_per_sec": frames / seconds,
        "calls": args.profile_calls,
        "steps_per_call": args.steps_per_call,
    }
    print(json.dumps(result), flush=True)
    return learner, state, result


def _remote_loop(args, agent, env, replay=None, num_training_envs=None):
    """The remote learner's loop with the device loops' signature:
    ``run_remote_learner`` without a replay (V-trace, PPO),
    ``run_remote_offpolicy_learner`` with one (R2D2, SAC); the bridge acts
    with the generator seed 1 of the CLI's rollout engines."""
    from seed_rl_torch import remote
    from seed_rl_torch.rollout import zero_action_for_space

    obs_spec = env.observation_spec()
    common = dict(
        inference_batch_size=args.inference_batch_size,
        config_push={"unroll_length": args.unroll_length,
                     "num_envs": args.num_envs},
        seed=1)

    def loop(learner, total_environment_frames, logger=None, checkpoint=None,
             log_every_steps=10, steps_per_call=1):
        del steps_per_call  # one update or cycle at a time
        if replay is None:
            return remote.run_remote_learner(
                agent, learner, obs_spec, args.server_address,
                total_environment_frames, args.unroll_length, args.num_envs,
                logger=logger, checkpoint=checkpoint,
                log_every_steps=log_every_steps, **common)
        replay_dir = (os.path.join(os.path.abspath(args.logdir), "replay")
                      if args.checkpoint_replay else None)
        return remote.run_remote_offpolicy_learner(
            agent, learner, replay, obs_spec, args.server_address,
            total_environment_frames, args.unroll_length, args.num_envs,
            replay_ratio=_replay_ratio(args),
            replay_buffer_min_size=args.replay_buffer_min_size,
            example_action=zero_action_for_space(env.action_space).numpy(),
            num_training_envs=num_training_envs,
            num_overlapping_steps=args.burn_in if args.agent == "r2d2" else 0,
            logger=logger, checkpoint=checkpoint,
            log_every_cycles=log_every_steps, replay_dir=replay_dir,
            **common)

    return loop


def _remote_engine(args, env, agent, device):
    """A remote V-trace or PPO learner's engine: over a ``SpecHostEnv``
    (specs only, never stepped), as the JAX CLI builds it."""
    from seed_rl_torch.remote import SpecHostEnv
    from seed_rl_torch.rollout_host import HostRolloutEngine

    spec_env = SpecHostEnv(env.observation_spec(), env.action_space,
                           args.num_envs)
    return HostRolloutEngine(spec_env, agent, args.unroll_length,
                             device=device, seed=1)


def _engine(args, env, host, agent, device, overlap=0):
    """The rollout engine of the env's kind, seeded 1."""
    if host:
        from seed_rl_torch.rollout_host import HostRolloutEngine

        return HostRolloutEngine(env, agent, args.unroll_length,
                                 num_overlapping_steps=overlap,
                                 device=device, seed=1)
    from seed_rl_torch.rollout import RolloutEngine

    return RolloutEngine(env, agent, args.unroll_length,
                         num_overlapping_steps=overlap, seed=1)


def _policy_net(args, env, dist, device):
    """The JAX CLI's V-trace / discrete-PPO net of an env with frames:
    ImpalaDeep on DmLab (or under --conv_net=impala_deep), AtariPolicyNet
    (LSTM 256) on Atari-shaped frames, GFootball on Football; None on a
    vector env."""
    from seed_rl_torch.models import AtariPolicyNet, GFootball, ImpalaDeep

    obs_shape = tuple(env.observation_spec().shape)
    if args.conv_net == "impala_deep" or args.env == "dmlab":
        return ImpalaDeep(num_actions=env.action_space.n,
                          observation_shape=obs_shape,
                          remat=args.remat_torso, seed=0, device=device)
    if args.env in ATARI_FRAME_ENVS:
        return AtariPolicyNet(
            parametric_distribution_param_size=dist.param_size,
            frame_shape=obs_shape[:2], stack_size=4, lstm_size=256, seed=0,
            device=device)
    if args.env == "football":
        return GFootball(parametric_distribution_param_size=dist.param_size,
                         observation_shape=obs_shape, seed=0, device=device)
    return None


def _vtrace_learner(args, env, host, optimizer, device):
    from seed_rl_torch import distributions as pd
    from seed_rl_torch.agent import NormalizingObservationsAgent, PolicyAgent
    from seed_rl_torch.agents import vtrace as vtrace_agent
    from seed_rl_torch.models import MLPAndLSTM
    from seed_rl_torch.ops.normalizer import observation_width

    dist = pd.get_parametric_distribution_for_action_space(env.action_space)
    obs_shape = tuple(env.observation_spec().shape)
    net = _policy_net(args, env, dist, device)
    if net is None:
        net = MLPAndLSTM(
            parametric_distribution_param_size=dist.param_size,
            input_size=math.prod(obs_shape),
            seed=0,
            device=device,
        )
    agent = PolicyAgent(net, dist)
    if args.normalize_observations:
        agent = NormalizingObservationsAgent(
            agent, observation_width(env.observation_spec()))
    config = vtrace_agent.VTraceConfig(
        discounting=args.discounting,
        entropy_cost=args.entropy_cost,
    )
    components = _apply_agent_module(args, env, {
        "net": net, "dist": dist, "agent": agent, "config": config,
        "optimizer": optimizer})
    agent, config, optimizer = (components["agent"], components["config"],
                                components["optimizer"])
    if args.run_mode == "learner":
        learner = vtrace_agent.VTraceLearner(
            _remote_engine(args, env, agent, device), agent, config,
            optimizer, seed=2)
        return learner, _remote_loop(args, agent, env)
    engine = _engine(args, env, host, agent, device)
    learner = vtrace_agent.VTraceLearner(
        engine, agent, config, optimizer, seed=2
    )
    if host:
        return learner, _host_loop(engine,
                                   pipeline=args.pipeline_host_rollouts)
    return learner, vtrace_agent.learner_loop


def _r2d2_learner(args, env, host, optimizer, device):
    from seed_rl_torch.agents import r2d2
    from seed_rl_torch.models import DuelingLSTMDQNNet, VectorDuelingDQNNet
    from seed_rl_torch.replay_host import HostReplayBuffer

    if not hasattr(env.action_space, "n"):
        raise ValueError(f"R2D2 needs discrete actions; --env={args.env} has "
                         f"{env.action_space}")
    obs_shape = tuple(env.observation_spec().shape)
    if args.env in ATARI_FRAME_ENVS:
        net = DuelingLSTMDQNNet(
            num_actions=env.action_space.n, frame_shape=obs_shape[:2],
            seed=0, device=device,
        )
    else:
        net = VectorDuelingDQNNet(
            num_actions=env.action_space.n,
            input_size=math.prod(obs_shape),
            seed=0,
            device=device,
        )
    num_training = args.num_envs - args.num_eval_envs
    config = r2d2.R2D2Config(
        discounting=args.discounting,
        n_steps=args.n_steps,
        burn_in=args.burn_in,
        replay_buffer_size=args.replay_buffer_size,
        replay_buffer_min_size=args.replay_buffer_min_size,
        batch_size=args.batch_size,
        update_target_every_n_step=args.update_target_every_n_step,
        num_eval_envs=args.num_eval_envs,
        train_batches_per_step=args.train_batches_per_step,
        target=args.target,
        retrace_lambda=args.retrace_lambda,
    )
    epsilons = torch.cat([
        r2d2.training_env_epsilons(num_training, device),
        torch.full((args.num_eval_envs,), config.eval_epsilon, device=device),
    ])
    if not host:
        epsilons = epsilons[env.env_ids]  # a rank's envs' (all on one)
    agent = r2d2.R2D2Agent(net, epsilons)
    components = _apply_agent_module(args, env, {
        "net": net, "agent": agent, "config": config,
        "optimizer": optimizer})
    agent, config, optimizer = (components["agent"], components["config"],
                                components["optimizer"])
    if args.run_mode == "learner":
        # The remote loop keeps the eval envs' unrolls out by env id, so
        # every unroll of an insertion batch is a training env's.
        learner = r2d2.R2D2HostLearner(
            agent, dataclasses.replace(config, num_eval_envs=0), optimizer,
            _insertion_batch(args), args.unroll_length)
        replay = HostReplayBuffer(args.replay_buffer_size,
                                  config.importance_sampling_exponent,
                                  device=device)
        return learner, _remote_loop(args, agent, env, replay, num_training)
    engine = _engine(args, env, host, agent, device, overlap=args.burn_in)
    if host:
        learner = r2d2.R2D2HostLearner(agent, config, optimizer,
                                       args.num_envs, args.unroll_length)
        return learner, _offpolicy_host_loop(
            args, engine, config.importance_sampling_exponent, device)
    learner = r2d2.R2D2Learner(engine, agent, config, optimizer, seed=2)
    return learner, r2d2.learner_loop


def _ppo_learner(args, env, host, optimizer, device):
    from seed_rl_torch import distributions as pd
    from seed_rl_torch.agent import PolicyAgent
    from seed_rl_torch.agents.ppo import policy_losses
    from seed_rl_torch.agents.ppo.continuous_control_agent import (
        ContinuousControlNet,
        NormalizingPolicyAgent,
    )
    from seed_rl_torch.agents.ppo.generalized_onpolicy_loss import (
        GeneralizedOnPolicyLoss,
    )
    from seed_rl_torch.agents.ppo.input_normalization import (
        InputNormalization,
    )
    from seed_rl_torch.agents.ppo.learner import (
        PPOConfig,
        PPOLearner,
        learner_loop,
    )
    from seed_rl_torch.agents.ppo.policy_regularizers import (
        KLPolicyRegularizer,
    )
    from seed_rl_torch.models import MLPAndLSTM
    from seed_rl_torch.ops.advantages import GAE, VTrace
    from seed_rl_torch.ops.popart import PopArt
    from seed_rl_torch.ops.running_statistics import AverageMeanStd

    space = env.action_space
    obs_shape = tuple(env.observation_spec().shape)
    if hasattr(space, "n") or hasattr(space, "nvec"):  # discrete
        dist = pd.get_parametric_distribution_for_action_space(space)
        net = _policy_net(args, env, dist, device)
        if net is None:
            net = MLPAndLSTM(
                parametric_distribution_param_size=dist.param_size,
                input_size=math.prod(obs_shape), seed=0, device=device)
        agent = PolicyAgent(net, dist)
    else:  # continuous: the HalfCheetah PPO net and input normalization
        dist = pd.get_parametric_distribution_for_action_space(
            space, pd.continuous_action_config(
                action_gaussian_std_fn="safe_exp"))
        obs_size = math.prod(obs_shape)
        net = ContinuousControlNet(
            parametric_distribution_param_size=dist.param_size,
            input_size=obs_size, num_layers_policy=2, num_layers_value=2,
            num_units_policy=64, num_units_value=64, activation=torch.tanh,
            kernel_init_gain=math.sqrt(2.0),
            last_kernel_init_policy_gain=0.01,
            last_kernel_init_value_gain=1.0, std_independent_of_input=True,
            seed=0, device=device)
        agent = NormalizingPolicyAgent(
            net, dist,
            input_normalization=InputNormalization(AverageMeanStd(),
                                                   input_size=obs_size),
            input_clipping=10.0)
    policy_loss = {
        "ppo": lambda: policy_losses.ppo(epsilon=args.ppo_epsilon),
        "vmpo": lambda: policy_losses.vmpo(e_n=args.vmpo_e_n),
        "awr": lambda: policy_losses.awr(beta=args.awr_beta,
                                         w_max=args.awr_w_max),
        "pg": policy_losses.pg,
        "vtrace": policy_losses.vtrace_is,
    }[args.policy_loss]()
    estimator = (GAE if args.advantage_estimator == "gae" else VTrace)(
        lambda_=args.lambda_)
    loss = GeneralizedOnPolicyLoss(
        agent=agent,
        reward_normalizer=PopArt(AverageMeanStd(), compensate=False),
        parametric_action_distribution=dist,
        advantage_estimator=estimator,
        policy_loss=policy_loss,
        discount_factor=args.discounting,
        regularizer=KLPolicyRegularizer(entropy=args.ppo_entropy_cost),
        baseline_cost=1.0,
    )
    config = PPOConfig(
        epochs_per_step=args.epochs_per_step,
        batch_mode=args.batch_mode or ("split" if net.stateless
                                       else "shuffle"),
        batches_per_step=args.batches_per_step,
    )
    components = _apply_agent_module(args, env, {
        "net": net, "dist": dist, "agent": agent, "loss": loss,
        "config": config, "optimizer": optimizer})
    agent, loss, config, optimizer = (
        components["agent"], components["loss"], components["config"],
        components["optimizer"])
    if args.run_mode == "learner":
        learner = PPOLearner(_remote_engine(args, env, agent, device), agent,
                             loss, config, optimizer, seed=2)
        return learner, _remote_loop(args, agent, env)
    engine = _engine(args, env, host, agent, device)
    learner = PPOLearner(engine, agent, loss, config, optimizer, seed=2)
    if host:
        return learner, _host_loop(engine,
                                   pipeline=args.pipeline_host_rollouts)
    return learner, functools.partial(
        learner_loop, num_checkpoints=args.num_checkpoints,
        num_saved_models=args.num_saved_models,
        num_snapshots=args.num_snapshots, logdir=args.logdir)


def _sac_learner(args, env, host, optimizer, device):
    from seed_rl_torch import distributions as pd
    from seed_rl_torch.agents import sac
    from seed_rl_torch.envs import BitFlippingEnv
    from seed_rl_torch.models import (
        ActorCriticLSTM,
        ActorCriticMLP,
        VisualActorCritic,
    )
    from seed_rl_torch.ops.normalizer import observation_width

    space = env.action_space
    dist = pd.get_parametric_distribution_for_action_space(space)
    discrete = hasattr(space, "n")
    spec = env.observation_spec()
    # Frames take VisualActorCritic; the JAX CLI builds it on Catch only,
    # and an MLP over the frames of the host envs, which cannot act.
    net_type = (VisualActorCritic if args.env in PIXEL_ENVS
                else ActorCriticLSTM if args.sac_net == "lstm"
                else ActorCriticMLP)
    net = net_type(
        parametric_distribution_param_size=dist.param_size,
        observation_spec=spec, n_critics=2,
        action_dim=1 if discrete else None, seed=0, device=device)
    agent = sac.SACAgent(net, dist, observation_width(spec)
                         if args.normalize_observations else None)
    target_entropy = args.target_entropy
    if target_entropy == "auto":
        # The standard SAC heuristic: -dim of the action space.
        target_entropy = -float(1 if discrete else math.prod(space.shape))
    elif target_entropy is not None:
        target_entropy = float(target_entropy)
    her_window = args.her_window_length or None
    config = sac.SACConfig(
        discounting=args.discounting,
        entropy_cost=args.sac_entropy_cost,
        target_entropy=target_entropy,
        entropy_cost_adjustment_speed=args.entropy_cost_adjustment_speed,
        bootstrap_net=args.bootstrap_net,
        batch_size=args.batch_size,
        replay_buffer_size=args.replay_buffer_size,
        replay_buffer_min_size=args.replay_buffer_min_size,
        unroll_length=args.unroll_length,
        her_window_length=her_window,
        polyak=args.polyak,
    )
    components = _apply_agent_module(args, env, {
        "net": net, "dist": dist, "agent": agent, "config": config,
        "optimizer": optimizer})
    agent, config, optimizer = (components["agent"], components["config"],
                                components["optimizer"])
    if args.run_mode == "learner":
        from seed_rl_torch.replay_host import HostReplayBuffer

        learner = sac.SACHostLearner(agent, config, optimizer,
                                     _insertion_batch(args),
                                     args.unroll_length, seed=2)
        replay = HostReplayBuffer(args.replay_buffer_size, 0.0, device=device)
        return learner, _remote_loop(args, agent, env, replay)
    if host:
        engine = _engine(args, env, host, agent, device)
        learner = sac.SACHostLearner(agent, config, optimizer, args.num_envs,
                                     args.unroll_length, seed=2)
        return learner, _offpolicy_host_loop(args, engine, 0.0, device)
    from seed_rl_torch.rollout import RolloutEngine

    engine = RolloutEngine(env, agent, her_window or args.unroll_length,
                           seed=1)
    learner = sac.SACLearner(
        engine, agent, config, optimizer,
        compute_reward_fn=BitFlippingEnv.compute_reward if her_window
        else None,
        seed=2)
    return learner, sac.learner_loop


if __name__ == "__main__":
    main()
