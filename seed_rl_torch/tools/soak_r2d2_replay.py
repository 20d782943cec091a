"""Reference-scale soak of the host R2D2 data plane.

The port of ``scripts/soak_r2d2_replay.py``. It measures whether the
reference's cloud R2D2 replay configuration fits and sustains on one
learner host: a 100k-unroll host-RAM buffer (unroll 80 + burn-in 40 +
bootstrap = 121 timesteps of 84x84 uint8 frames an item, ~86 GiB; the
reference's gcp/train_atari.sh:28-33 asks a >104 GB-RAM master for it),
filled, then driven through ``host_offpolicy_loop``'s sustained cycle:
insert, prioritized sample (the prefetch thread gathering and copying the
next batch while the card trains), train on the full ``DuelingLSTMDQNNet``
(``R2D2HostLearner``), priority write-back, at the reference's replay
ratio 0.75 (insertion batch = batch 64 / 0.75 = 85 unrolls).

Synthetic unrolls stand in for env stepping (the host paths measure
that), so the numbers isolate the replay data plane.

Run:  python -m seed_rl_torch.tools.soak_r2d2_replay           # 100k scale
      python -m seed_rl_torch.tools.soak_r2d2_replay --buffer_size=2000 \\
          --seconds=10 [--device=cpu]

Prints one JSON line: steady-state env frames/s, train batches/s, the
buffer's GiB, peak RSS GiB, each stage of one cycle in ms, and the host to
device copy rate.
"""

import argparse
import json
import resource
import time

import numpy as np
import torch


def _rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_synthetic_unroll(agent, batch, t_total, frame_shape, num_actions,
                          device, seed=7):
    """A time-major ``[T, B]`` unroll of random uint8 frames and actions,
    with the dtypes and shapes of an Atari R2D2 unroll."""
    from seed_rl_torch.rollout import Timestep, Unroll
    from seed_rl_torch.types import EnvOutput, QAgentOutput

    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    h, w = frame_shape
    actions = torch.randint(0, num_actions, (t_total, batch),
                            generator=generator, device=device,
                            dtype=torch.int32)
    env_output = EnvOutput(
        reward=torch.zeros((t_total, batch), device=device),
        done=torch.zeros((t_total, batch), dtype=torch.bool, device=device),
        observation=torch.randint(0, 255, (t_total, batch, h, w, 1),
                                  generator=generator, device=device,
                                  dtype=torch.uint8),
        abandoned=torch.zeros((t_total, batch), dtype=torch.bool,
                              device=device),
        episode_step=torch.arange(t_total, dtype=torch.int32,
                                  device=device)[:, None].expand(
                                      t_total, batch).contiguous(),
    )
    agent_output = QAgentOutput(
        action=actions,
        q_values=torch.randn((t_total, batch, num_actions),
                             generator=generator, device=device))
    return Unroll(
        agent_state=agent.initial_state(batch),
        timesteps=Timestep(prev_action=torch.roll(actions, 1, dims=0),
                           env_output=env_output,
                           agent_output=agent_output))


def _h2d_mib_per_sec(array, device, reps=2):
    """Host to device copy rate of ``array`` (pinned, as the replay's
    prefetch copies), in MiB/s."""
    host = torch.from_numpy(array)
    if device.type == "cuda":
        host = host.pin_memory()
    host.to(device)
    _synchronize(device)
    start = time.perf_counter()
    for _ in range(reps):
        host.to(device, non_blocking=True)
    _synchronize(device)
    return array.nbytes / 2 ** 20 / ((time.perf_counter() - start) / reps)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--buffer_size", type=int, default=100_000,
                   help="the reference gcp/train_atari.sh: 100000 unrolls")
    p.add_argument("--unroll_length", type=int, default=80)
    p.add_argument("--burn_in", type=int, default=40)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--replay_ratio", type=float, default=0.75)
    p.add_argument("--num_actions", type=int, default=18)
    p.add_argument("--lstm_size", type=int, default=512)
    p.add_argument("--seconds", type=float, default=120.0,
                   help="the sustained phase's duration")
    p.add_argument("--fill_report_every", type=int, default=200)
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA device")
    args = p.parse_args(argv)

    from seed_rl_torch import optim
    from seed_rl_torch.agents import r2d2
    from seed_rl_torch.device import resolve_device
    from seed_rl_torch.host_offpolicy import train_owed
    from seed_rl_torch.models import DuelingLSTMDQNNet
    from seed_rl_torch.replay_host import HostReplayBuffer

    device = resolve_device(args.device)
    insertion_batch = max(1, int(round(args.batch_size / args.replay_ratio)))
    t_total = args.burn_in + args.unroll_length + 1
    frame_shape = (84, 84)

    net = DuelingLSTMDQNNet(num_actions=args.num_actions,
                            frame_shape=frame_shape,
                            lstm_size=args.lstm_size, seed=0, device=device)
    agent = r2d2.R2D2Agent(
        net, r2d2.training_env_epsilons(insertion_batch, device))
    config = r2d2.R2D2Config(
        burn_in=args.burn_in, n_steps=5, batch_size=args.batch_size,
        replay_buffer_size=args.buffer_size,
        replay_buffer_min_size=args.buffer_size,
        update_target_every_n_step=2500, num_eval_envs=0)
    learner = r2d2.R2D2HostLearner(
        agent, config,
        lambda params: optim.ClippedAdam(params, learning_rate=1e-4,
                                         clip_norm=80.0),
        insertion_batch, args.unroll_length)
    replay = HostReplayBuffer(args.buffer_size,
                              config.importance_sampling_exponent,
                              device=device)

    state = learner.init()
    unroll = make_synthetic_unroll(agent, insertion_batch, t_total,
                                   frame_shape, args.num_actions, device)
    with torch.no_grad():
        items, priorities = learner.make_items_and_priorities(unroll)
    # Host-resident once, as the host loop's items are after their copy.
    items = torch.utils._pytree.tree_map(lambda t: t.cpu().numpy(), items)
    priorities = priorities.cpu().numpy()
    item_bytes = sum(leaf[0].nbytes
                     for leaf in torch.utils._pytree.tree_leaves(items))
    print(f"soak: item={item_bytes / 2 ** 20:.2f} MiB, buffer target "
          f"{args.buffer_size * item_bytes / 2 ** 30:.1f} GiB, "
          f"insertion_batch={insertion_batch}, T={t_total}, device={device}",
          flush=True)

    # Phase 1: fill to capacity (ring-insert throughput and RAM).
    fill_start = time.perf_counter()
    cycles = 0
    while replay.num_inserted < args.buffer_size:
        replay.insert(items, priorities)
        cycles += 1
        if cycles % args.fill_report_every == 0:
            seconds = time.perf_counter() - fill_start
            print(f"fill: {replay.num_inserted}/{args.buffer_size}, "
                  f"{replay.nbytes() / 2 ** 30:.1f} GiB, "
                  f"rss={_rss_gib():.1f} GiB, "
                  f"{replay.num_inserted * args.unroll_length / seconds:.0f}"
                  " frames/s", flush=True)
    fill_seconds = time.perf_counter() - fill_start
    fill_gib = replay.nbytes() / 2 ** 30

    # One train batch outside the measured window (the first call's cuDNN
    # and allocator warm-up).
    indices, weights, batch = replay.sample(args.batch_size,
                                            config.priority_exponent)
    state, new_priorities, _ = learner.train_on_batch(
        state, batch, torch.as_tensor(weights, device=device))
    replay.update_priorities(indices, new_priorities.cpu().numpy())

    # Phase 2: the host loop's sustained cycle at the replay ratio, the
    # prefetch overlapping the card's step.
    owed = 0.0
    train_batches = 0
    sustained_frames = 0
    start = time.perf_counter()
    while time.perf_counter() - start < args.seconds:
        replay.insert(items, priorities)
        sustained_frames += insertion_batch * args.unroll_length
        state, owed, batch_logs = train_owed(
            learner, replay, state, owed,
            args.replay_ratio * insertion_batch)
        train_batches += len(batch_logs)
    _synchronize(device)
    sustained_seconds = time.perf_counter() - start

    probe = np.random.default_rng(0).integers(0, 256, (16 << 20,),
                                              dtype=np.uint8)
    h2d = _h2d_mib_per_sec(probe, device)

    # One cycle's stages, each on its own.
    t0 = time.perf_counter()
    replay.insert(items, priorities)
    insert_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _, host_weights, host_batch = replay.sample(
        args.batch_size, config.priority_exponent, to_device=False)
    gather_ms = (time.perf_counter() - t0) * 1e3
    batch_mib = sum(leaf.nbytes for leaf in
                    torch.utils._pytree.tree_leaves(host_batch)) / 2 ** 20
    t0 = time.perf_counter()
    batch = replay.upload(host_batch)
    _synchronize(device)
    h2d_ms = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    state, new_priorities, _ = learner.train_on_batch(
        state, batch, torch.as_tensor(host_weights, device=device))
    new_priorities.cpu()
    train_ms = (time.perf_counter() - t0) * 1e3

    result = {
        "metric": "r2d2_host_replay_soak",
        "buffer_unrolls": args.buffer_size,
        "buffer_gib": fill_gib,
        "h2d_mib_per_sec": h2d,
        "stage_ms": {"insert": insert_ms, "sample_gather": gather_ms,
                     "h2d": h2d_ms, "train": train_ms,
                     "batch_mib": batch_mib},
        "rss_gib": _rss_gib(),
        "fill_frames_per_sec": (args.buffer_size * args.unroll_length
                                / fill_seconds),
        "sustained_env_frames_per_sec": sustained_frames / sustained_seconds,
        "train_batches_per_sec": train_batches / sustained_seconds,
        "train_batches": train_batches,
        "sustained_secs": sustained_seconds,
        "device": str(device),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
