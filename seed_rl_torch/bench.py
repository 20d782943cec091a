"""Benchmark of the port: env frames/s on one card for the bench workloads.

The port's counterpart of the JAX package's ``bench.py`` (the file at the
root of the repo stays the JAX one). Run on the card:

    python -m seed_rl_torch.bench [--device=cpu]

It prints one JSON line per workload to stdout, under ``bench.py``'s metric
names and in its order, the R2D2 line last:

1. ``ppo_vector_obs_tracking_fps_per_chip``: PPO with the HalfCheetah-style
   composition (GAE, PPO-epsilon loss, PopArt, input normalization, split
   batch mode, 10 epochs x 32 minibatches) on the 4-dim toy env; tracking.
2. ``sac_visual_catch_env_frames_per_sec_per_chip``: visual SAC on the
   on-device continuous Catch env (shared conv encoder in bf16, 512 envs,
   batch 1024, 4 minibatches a step, polyak each); tracking.
3. ``football_vtrace_env_frames_per_sec_per_chip``: the GFootball 4-stack
   resnet in bf16 over bit-packed SMM frames unpacked on the card, V-trace.
4. ``ppo_atari_env_frames_per_sec_per_chip``: conv PPO, AtariPolicyNet in
   bf16 over 84x84 frames, shuffle batch mode, 2 epochs x 8 minibatches.
5. ``dmlab_vtrace_env_frames_per_sec_per_chip``: ImpalaDeep in bf16 on
   72x96x3 DmLab-shaped frames, V-trace.
6. ``vtrace_atari_env_frames_per_sec_per_chip``: AtariPolicyNet (LSTM 256)
   in bf16 over 84x84 frames, V-trace, 2 train steps a call.
7. ``scaling_efficiency_1_to_N_replicas``: only with two or more CUDA
   devices, through ``tools/bench_scaling.py`` (one rank per card, NCCL);
   on one card it prints nothing, as ``bench.py`` does on one chip.
8. ``r2d2_atari_env_frames_per_sec_per_chip``: R2D2 at the reference cloud
   shape (640 envs, unroll 80, burn-in 40, batch 64, prioritized replay of
   1280 unrolls, target net), DuelingLSTMDQNNet with its torso and LSTM in
   bf16.

Each workload uses ``bench.py``'s envs, nets, compute dtypes, configs,
optimizers, ``num_envs``, unroll lengths, steps a call and calls, and
takes ``num_envs``, ``calls`` and ``windows`` as keyword arguments (their
defaults are ``bench.py``'s) so that a smaller run can be made.

A line holds ``metric``, ``value`` (the median of ``windows`` measurement
windows, env frames/s), ``unit``, ``vs_baseline``, ``spread`` ((max - min)
/ median over the windows), ``tracking`` where ``bench.py`` sets it, and
``mfu`` = value x FLOPs per env frame / the H100 SXM5's dense bf16 peak
(``utils/flops.py``'s models, with ``bench.py``'s pass counts; the torsos
run in bf16). ``vs_baseline`` is null on every line: ``bench.py``'s anchor
is a figure of another accelerator, which the port does not use. Numbers
are printed unrounded.

Timing: one warm-up call (which also builds the kernels and fills the
allocator), then ``windows`` windows of ``calls`` calls each, every window
closed by ``torch.cuda.synchronize()``. The card's name and power limit
(``nvidia-smi``) go to stderr; stdout holds only the JSON lines.
"""

import argparse
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from seed_rl_torch.utils import flops as fm

NUM_WINDOWS = int(os.environ.get("BENCH_WINDOWS", "3"))


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measure(run, state, frames_per_call, calls, windows, device):
    """Median frames/s over ``windows`` windows of ``calls`` calls, and the
    spread (max - min) / median."""
    state = run(state)  # warm-up: builds, first allocations
    _synchronize(device)
    fps = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            state = run(state)
        _synchronize(device)
        fps.append(calls * frames_per_call / (time.perf_counter() - t0))
    med = float(np.median(fps))
    spread = float((max(fps) - min(fps)) / med) if med else 0.0
    return med, spread


def _emit(metric, fps, spread, flops_per_frame, tracking=False):
    """Prints one workload's JSON line and returns it."""
    line = {"metric": metric, "value": fps, "unit": "frames/s",
            "vs_baseline": None, "spread": spread}
    if tracking:
        line["tracking"] = True
    line["mfu"] = fps * flops_per_frame / fm.PEAK_BF16_FLOPS
    print(json.dumps(line), flush=True)
    return line


def _adam(learning_rate, clip_norm):
    from seed_rl_torch import optim

    return functools.partial(optim.ClippedAdam, learning_rate=learning_rate,
                             clip_norm=clip_norm)


def _train_many(learner, steps):
    return lambda state: learner.train_many(state, steps)[0]


def _vtrace_learner(env, net, dist, unroll_length):
    from seed_rl_torch.agent import PolicyAgent
    from seed_rl_torch.agents import vtrace
    from seed_rl_torch.rollout import RolloutEngine

    agent = PolicyAgent(net, dist)
    engine = RolloutEngine(env, agent, unroll_length, seed=1)
    return vtrace.VTraceLearner(engine, agent, vtrace.VTraceConfig(),
                                _adam(3e-4, 40.0), seed=2)


def _windows(windows):
    return NUM_WINDOWS if windows is None else windows


def vtrace_atari_learner(device, num_envs=1024, unroll_length=32,
                         mesh=None):
    """V-trace with the bf16 AtariPolicyNet (LSTM 256) on synthetic 84x84
    Atari frames, 18 actions (``bench.py::build_learner``); ``mesh``: this
    rank's share of the envs (``seed_rl_torch.parallel``)."""
    from seed_rl_torch import distributions as pd
    from seed_rl_torch.envs import BatchedEnv
    from seed_rl_torch.envs.synthetic import SyntheticAtariEnv
    from seed_rl_torch.models import AtariPolicyNet

    num_actions = 18
    env = BatchedEnv(SyntheticAtariEnv(num_actions=num_actions), num_envs,
                     device=device, mesh=mesh)
    dist = pd.CategoricalDistribution(num_actions)
    net = AtariPolicyNet(dist.param_size, stack_size=4, lstm_size=256,
                         dtype=torch.bfloat16, seed=0, device=device)
    return _vtrace_learner(env, net, dist, unroll_length)


def bench_vtrace(device, num_envs=1024, calls=8, windows=None):
    unroll_length, steps_per_call, num_actions = 32, 2, 18
    learner = vtrace_atari_learner(device, num_envs, unroll_length)
    fps, spread = _measure(
        _train_many(learner, steps_per_call), learner.init(),
        steps_per_call * num_envs * unroll_length, calls, _windows(windows),
        device)
    # Per env frame: 1 rollout fwd + (T+1)/T train frames at fwd+bwd (=3x).
    fpf = fm.atari_policy_net(num_actions, lstm_size=256) * (
        1.0 + 3.0 * (unroll_length + 1) / unroll_length)
    return _emit("vtrace_atari_env_frames_per_sec_per_chip", fps, spread,
                 fpf)


def r2d2_atari_learner(device, num_envs=640, unroll=80, burn_in=40,
                       replay_buffer_size=1280, batch_size=64):
    """R2D2 with the bf16 DuelingLSTMDQNNet on synthetic 84x84 Atari
    frames, 18 actions: n 5, a replay of ``replay_buffer_size`` unrolls
    with a minimum of 8, the target net every 2500 batches, Adam 1e-4
    clipped at 80 (the reference cloud shape's knobs)."""
    from seed_rl_torch.agents import r2d2
    from seed_rl_torch.envs import BatchedEnv
    from seed_rl_torch.envs.synthetic import SyntheticAtariEnv
    from seed_rl_torch.models import DuelingLSTMDQNNet
    from seed_rl_torch.rollout import RolloutEngine

    num_actions = 18
    env = BatchedEnv(SyntheticAtariEnv(num_actions=num_actions), num_envs,
                     device=device)
    net = DuelingLSTMDQNNet(num_actions, dtype=torch.bfloat16,
                            core_dtype=torch.bfloat16, seed=0, device=device)
    agent = r2d2.R2D2Agent(net, r2d2.training_env_epsilons(num_envs, device))
    engine = RolloutEngine(env, agent, unroll, num_overlapping_steps=burn_in,
                           seed=1)
    config = r2d2.R2D2Config(
        n_steps=5, burn_in=burn_in, replay_buffer_size=replay_buffer_size,
        replay_buffer_min_size=8, batch_size=batch_size,
        update_target_every_n_step=2500)
    return r2d2.R2D2Learner(engine, agent, config, _adam(1e-4, 80.0), seed=2)


def warm_replay(learner):
    """A fresh train state with the replay filled to its minimum."""
    state = learner.init()
    while state.replay.num_inserted < learner.config.replay_buffer_min_size:
        state = learner.warmup_step(state)
    return state


def bench_r2d2(device, num_envs=640, calls=8, windows=None):
    unroll, burn_in, num_actions = 80, 40, 18
    learner = r2d2_atari_learner(device, num_envs, unroll, burn_in)
    config = learner.config
    state = warm_replay(learner)
    fps, spread = _measure(_train_many(learner, 1), state,
                           num_envs * unroll, calls, _windows(windows),
                           device)
    # Per step: rollout num_envs x unroll frames x 1 fwd; a train batch of
    # 64 unrolls of burn-in 40 (online + target fwd = 2x) + 81 trained
    # steps (online fwd+bwd + target fwd = 4x), per env frame.
    fwd = fm.dueling_lstm_dqn_net(num_actions, lstm_size=512)
    train_fwd_eq = config.batch_size * (burn_in * 2 + (unroll + 1) * 4)
    fpf = fwd * (1.0 + train_fwd_eq / (num_envs * unroll))
    return _emit("r2d2_atari_env_frames_per_sec_per_chip", fps, spread, fpf)


def bench_ppo(device, num_envs=1024, calls=8, windows=None):
    from seed_rl_torch import distributions as pd
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
    from seed_rl_torch.agents.ppo.learner import PPOConfig, PPOLearner
    from seed_rl_torch.agents.ppo.policy_regularizers import (
        KLPolicyRegularizer,
    )
    from seed_rl_torch.envs import BatchedEnv, ToyEnv
    from seed_rl_torch.ops.advantages import GAE
    from seed_rl_torch.ops.popart import PopArt
    from seed_rl_torch.ops.running_statistics import AverageMeanStd
    from seed_rl_torch.rollout import RolloutEngine

    unroll_length, steps_per_call = 16, 1
    env = BatchedEnv(ToyEnv(horizon=20), num_envs, device=device)
    dist = pd.NormalTanhDistribution(
        3, gaussian_std_fn=pd.safe_exp_std_fn(1.0, 1e-3))
    net = ContinuousControlNet(
        parametric_distribution_param_size=dist.param_size, input_size=4,
        num_layers_policy=2, num_layers_value=2, num_units_policy=64,
        num_units_value=64, activation=torch.tanh,
        kernel_init_gain=math.sqrt(2.0), last_kernel_init_policy_gain=0.01,
        last_kernel_init_value_gain=1.0, std_independent_of_input=True,
        seed=0, device=device)
    agent = NormalizingPolicyAgent(
        net, dist,
        input_normalization=InputNormalization(AverageMeanStd(),
                                               input_size=4),
        input_clipping=10.0)
    loss = GeneralizedOnPolicyLoss(
        agent=agent,
        reward_normalizer=PopArt(AverageMeanStd(), compensate=False),
        parametric_action_distribution=dist,
        advantage_estimator=GAE(lambda_=0.95),
        policy_loss=policy_losses.ppo(epsilon=0.2),
        discount_factor=0.99,
        regularizer=KLPolicyRegularizer(entropy=0.0),
        baseline_cost=1.0,
    )
    engine = RolloutEngine(env, agent, unroll_length, seed=1)
    config = PPOConfig(epochs_per_step=10, batch_mode="split",
                       batches_per_step=32)
    learner = PPOLearner(engine, agent, loss, config, _adam(3e-4, 0.5),
                         seed=2)
    fps, spread = _measure(
        _train_many(learner, steps_per_call), learner.init(),
        steps_per_call * num_envs * unroll_length, calls, _windows(windows),
        device)
    # The policy and value towers, 2 x 64 each; 10 epochs in split mode.
    fwd = 2 * (fm.dense(4, 64) + fm.dense(64, 64) + fm.dense(64, 6))
    fpf = fwd * (1.0 + 3.0 * 10)
    return _emit("ppo_vector_obs_tracking_fps_per_chip", fps, spread, fpf,
                 tracking=True)


def dmlab_vtrace_learner(device, num_envs=256, unroll_length=32,
                         remat=False):
    """V-trace with the bf16 ImpalaDeep (``remat``: its torso recomputed in
    the backward) on synthetic 72x96x3 DmLab frames, 9 actions."""
    from seed_rl_torch import distributions as pd
    from seed_rl_torch.envs import BatchedEnv
    from seed_rl_torch.envs.synthetic import SyntheticDmLabEnv
    from seed_rl_torch.models import ImpalaDeep

    num_actions = 9
    env = BatchedEnv(SyntheticDmLabEnv(num_actions=num_actions), num_envs,
                     device=device)
    dist = pd.CategoricalDistribution(num_actions)
    net = ImpalaDeep(num_actions, tuple(env.observation_spec().shape),
                     remat=remat, dtype=torch.bfloat16, seed=0,
                     device=device)
    return _vtrace_learner(env, net, dist, unroll_length)


def bench_dmlab_vtrace(device, num_envs=256, calls=8, windows=None):
    unroll_length, steps_per_call, num_actions = 32, 1, 9
    learner = dmlab_vtrace_learner(device, num_envs, unroll_length)
    fps, spread = _measure(
        _train_many(learner, steps_per_call), learner.init(),
        steps_per_call * num_envs * unroll_length, calls, _windows(windows),
        device)
    fpf = fm.impala_deep(num_actions) * (
        1.0 + 3.0 * (unroll_length + 1) / unroll_length)
    return _emit("dmlab_vtrace_env_frames_per_sec_per_chip", fps, spread,
                 fpf)


def ppo_atari_learner(device, num_envs=512, unroll_length=32,
                      batch_mode="shuffle", epochs=2, batches=8):
    """Conv PPO: the bf16 AtariPolicyNet (LSTM 256) on synthetic 84x84
    Atari frames, GAE 0.95, PPO clip 0.2, PopArt, entropy 0.01, Adam 3e-4
    clipped at 0.5, ``epochs`` x ``batches`` minibatches a step."""
    from seed_rl_torch import distributions as pd
    from seed_rl_torch.agent import PolicyAgent
    from seed_rl_torch.agents.ppo import policy_losses
    from seed_rl_torch.agents.ppo.generalized_onpolicy_loss import (
        GeneralizedOnPolicyLoss,
    )
    from seed_rl_torch.agents.ppo.learner import PPOConfig, PPOLearner
    from seed_rl_torch.agents.ppo.policy_regularizers import (
        KLPolicyRegularizer,
    )
    from seed_rl_torch.envs import BatchedEnv
    from seed_rl_torch.envs.synthetic import SyntheticAtariEnv
    from seed_rl_torch.models import AtariPolicyNet
    from seed_rl_torch.ops.advantages import GAE
    from seed_rl_torch.ops.popart import PopArt
    from seed_rl_torch.ops.running_statistics import AverageMeanStd
    from seed_rl_torch.rollout import RolloutEngine

    num_actions = 18
    env = BatchedEnv(SyntheticAtariEnv(num_actions=num_actions), num_envs,
                     device=device)
    dist = pd.CategoricalDistribution(num_actions)
    net = AtariPolicyNet(dist.param_size, stack_size=4, lstm_size=256,
                         dtype=torch.bfloat16, seed=0, device=device)
    agent = PolicyAgent(net, dist)
    loss = GeneralizedOnPolicyLoss(
        agent=agent,
        reward_normalizer=PopArt(AverageMeanStd(), compensate=False),
        parametric_action_distribution=dist,
        advantage_estimator=GAE(lambda_=0.95),
        policy_loss=policy_losses.ppo(epsilon=0.2),
        discount_factor=0.99,
        regularizer=KLPolicyRegularizer(entropy=0.01),
        baseline_cost=1.0,
    )
    engine = RolloutEngine(env, agent, unroll_length, seed=1)
    config = PPOConfig(epochs_per_step=epochs, batch_mode=batch_mode,
                       batches_per_step=batches)
    return PPOLearner(engine, agent, loss, config, _adam(3e-4, 0.5), seed=2)


def bench_ppo_atari(device, num_envs=512, calls=8, windows=None):
    unroll_length, steps_per_call, num_actions = 32, 1, 18
    learner = ppo_atari_learner(device, num_envs, unroll_length)
    config = learner.config
    fps, spread = _measure(
        _train_many(learner, steps_per_call), learner.init(),
        steps_per_call * num_envs * unroll_length, calls, _windows(windows),
        device)
    # Rollout 1 fwd; shuffle mode trains every (T+1)/T frame once an epoch
    # (2 epochs) at fwd+bwd.
    fpf = fm.atari_policy_net(num_actions, lstm_size=256) * (
        1.0 + config.epochs_per_step * 3.0
        * (unroll_length + 1) / unroll_length)
    return _emit("ppo_atari_env_frames_per_sec_per_chip", fps, spread, fpf)


def sac_visual_learner(device, num_envs=512, unroll=2, batch_size=1024,
                       minibatches=4, replay_buffer_size=16384):
    """Visual SAC on the on-device continuous Catch env: VisualActorCritic
    with its conv torso in bf16 and 2 critics, a replay with a minimum of
    8, ``minibatches`` batches a step, polyak 0.995 each, Adam 3e-4
    clipped at 40."""
    from seed_rl_torch import distributions as pd
    from seed_rl_torch.agents import sac
    from seed_rl_torch.envs import BatchedEnv, ContinuousCatchEnv
    from seed_rl_torch.models import VisualActorCritic
    from seed_rl_torch.rollout import RolloutEngine

    env = BatchedEnv(ContinuousCatchEnv(), num_envs, device=device)
    dist = pd.get_parametric_distribution_for_action_space(env.action_space)
    net = VisualActorCritic(dist.param_size, env.observation_spec(),
                            n_critics=2, conv_dtype=torch.bfloat16, seed=0,
                            device=device)
    agent = sac.SACAgent(net, dist)
    config = sac.SACConfig(
        batch_size=batch_size, train_batches_per_step=minibatches,
        replay_buffer_size=replay_buffer_size, replay_buffer_min_size=8,
        unroll_length=unroll, polyak=0.995)
    engine = RolloutEngine(env, agent, unroll, seed=1)
    return sac.SACLearner(engine, agent, config, _adam(3e-4, 40.0), seed=2)


def bench_sac_visual(device, num_envs=512, calls=8, windows=None):
    unroll, steps_per_call = 2, 4
    learner = sac_visual_learner(device, num_envs, unroll)
    config, env = learner.config, learner.engine.env
    dist = learner.agent.distribution
    state = warm_replay(learner)
    fps, spread = _measure(
        _train_many(learner, steps_per_call), state,
        steps_per_call * num_envs * unroll, calls, _windows(windows), device)
    h, w, cin = env.observation_spec().shape
    comp = fm.visual_actor_critic(param_size=dist.param_size, action_dim=1,
                                  n_critics=2, h=h, w=w, cin=cin)
    fpf = fm.sac_visual_flops_per_env_frame(
        comp, unroll=unroll, env_frames_per_step=num_envs * unroll,
        batch_size=config.batch_size,
        minibatches=config.train_batches_per_step)
    return _emit("sac_visual_catch_env_frames_per_sec_per_chip", fps, spread,
                 fpf, tracking=True)


def football_vtrace_learner(device, num_envs=256, unroll_length=32):
    """V-trace with the bf16 GFootball resnet over bit-packed 72x96 SMM
    frames of the synthetic Football env, unpacked on the device."""
    from seed_rl_torch import distributions as pd
    from seed_rl_torch.envs import BatchedEnv
    from seed_rl_torch.envs.synthetic import SyntheticFootballEnv
    from seed_rl_torch.models import GFootball

    env = BatchedEnv(SyntheticFootballEnv(), num_envs, device=device)
    dist = pd.CategoricalDistribution(19)
    net = GFootball(dist.param_size, tuple(env.observation_spec().shape),
                    dtype=torch.bfloat16, seed=0, device=device)
    return _vtrace_learner(env, net, dist, unroll_length)


def bench_football(device, num_envs=256, calls=8, windows=None):
    unroll_length = 32
    learner = football_vtrace_learner(device, num_envs, unroll_length)
    dist = learner.agent.distribution
    fps, spread = _measure(_train_many(learner, 1), learner.init(),
                           num_envs * unroll_length, calls,
                           _windows(windows), device)
    fpf = fm.gfootball_net(dist.param_size) * (
        1.0 + 3.0 * (unroll_length + 1) / unroll_length)
    return _emit("football_vtrace_env_frames_per_sec_per_chip", fps, spread,
                 fpf)


def bench_scaling(device, num_envs=256, calls=4, windows=None):
    """Weak scaling across cards: prints nothing with fewer than two CUDA
    devices, as ``bench.py`` does on one chip. With more, it runs the
    multi-card harness (``tools/bench_scaling.py``, NCCL, a rank per card)
    at ``bench.py``'s shape: V-trace x AtariPolicyNet, ``num_envs`` envs a
    replica, unroll 32, 2 steps a call, ``calls`` calls, at 1, 2, 4, ...
    replicas up to the card count; its line has ``bench.py``'s keys,
    ``vs_baseline`` null as on every line."""
    del windows
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    from seed_rl_torch.tools import bench_scaling as harness

    replicas, n = [], 1
    while n <= torch.cuda.device_count():
        replicas.append(n)
        n *= 2
    results = harness.measure_all(
        "atari", replicas, envs_per_replica=num_envs, unroll=32,
        steps_per_call=2, calls=calls, backend="nccl", device="cuda")
    n_max = replicas[-1]
    eff = results[n_max] / (results[1] * n_max)
    line = {"metric": f"scaling_efficiency_1_to_{n_max}_replicas",
            "value": eff, "unit": "fraction", "vs_baseline": None}
    print(json.dumps(line), flush=True)
    return line


# main's order: tracking lines first, the R2D2 line last (bench.py's).
WORKLOADS = (bench_ppo, bench_sac_visual, bench_football, bench_ppo_atari,
             bench_dmlab_vtrace, bench_vtrace, bench_scaling, bench_r2d2)


def card_description():
    """``name, power.limit`` of each card, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    """Runs every workload on the card (or ``--device=cpu``); returns the
    lines printed."""
    device = torch.device(parse_args(argv).device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device=cpu to run "
                               "on the CPU")
        from seed_rl_torch.ops.cuda import build

        build.build(["vtrace_kernel", "nstep_kernel"])
        print(card_description(), file=sys.stderr)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
              file=sys.stderr)
    return [line for line in (fn(device) for fn in WORKLOADS)
            if line is not None]


if __name__ == "__main__":
    main()
