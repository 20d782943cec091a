"""Per-stage decomposition of the visual-SAC Catch workload.

The port of ``scripts/profile_sac_visual.py``, at its config: 128 envs x
unroll 2 of the on-device continuous Catch env, batch 256, 4 minibatches a
step, polyak each (``build``: ``seed_rl_torch.bench.sac_visual_learner``
with the script's 4096-unroll replay, warmed to 64 unrolls;
VisualActorCritic with its conv torso in bf16). It prints:

  1. the stage table: the full train step, the rollout + insert + episode
     statistics, one minibatch update (sample, loss, clip + Adam, polyak)
     and their shares; inside the minibatch: the replay sample alone, the
     loss forward only, the loss forward and backward, and the polyak move
     alone, with their shares;
  2. the conv torso's batch-efficiency curve: the bf16 AtariConvTorso on
     84x84x1 frames, forward and forward + backward (a random cotangent, in
     the parameters) at 256, 512, 768, 2048 and 8448 frames;
  3. the torso-pass accounting: torso frame passes a step and per env
     frame, and the passes/s at the measured step, to set beside the
     V-trace Atari line's (``tools/profile_bench.py``'s full step times
     4 forward-equivalents a frame);
  4. the full step over envs x unroll: (128, 2), (256, 2), (512, 2),
     (128, 4), (256, 4).

Rows are timed and profiled as ``tools/_timing.py`` says. SAC has no
recursion over time: no kernel of the port is on this path.

Run:  python -m seed_rl_torch.tools.profile_sac_visual [--device=cpu]
          [--torso_batches=256,512,...] [--sweep=128x2,256x2,...]
          [--iters=20]
"""

import argparse

import torch

from seed_rl_torch.tools import _timing

# The stage table's config: envs, unroll, batch, minibatches a step.
NUM_ENVS, UNROLL, BATCH_SIZE, MINIBATCHES = 128, 2, 256, 4
TORSO_BATCHES = "256,512,768,2048,8448"
SWEEP = "128x2,256x2,512x2,128x4,256x4"
WARM_UNROLLS = 64


def build(num_envs=NUM_ENVS, unroll=UNROLL, batch_size=BATCH_SIZE,
          minibatches=MINIBATCHES, device="cuda"):
    """The script's learner and a state whose replay holds at least 64
    unrolls; returns (learner, state, config)."""
    from seed_rl_torch.bench import sac_visual_learner

    learner = sac_visual_learner(torch.device(device), num_envs, unroll,
                                 batch_size, minibatches,
                                 replay_buffer_size=4096)
    state = learner.init()
    while state.replay.num_inserted < WARM_UNROLLS:
        state = learner.warmup_step(state)
    return learner, state, learner.config


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _timing.add_device_flag(p)
    p.add_argument("--torso_batches", default=TORSO_BATCHES)
    p.add_argument("--sweep", default=SWEEP,
                   help="envs x unroll pairs of the full-step sweep")
    p.add_argument("--iters", type=int, default=20)
    return p.parse_args(argv)


def stage_table(learner, state, config, device, iters, env_frames):
    """Section 1's rows, by name."""
    from seed_rl_torch.agents import sac

    rows = {}
    held = {"state": state}

    def row(name, fn, frames=None):
        rows[name] = _timing.timeit(name, fn, device, iters, frames, 52)
        return rows[name].ms

    def full():
        held["state"] = learner.train_step(held["state"])[0]

    def rollout():
        held["state"] = learner.warmup_step(held["state"])

    def minibatch():
        held["state"] = learner.train_on_batch(held["state"])[0]

    mb = config.train_batches_per_step
    t_full = row("full train step", full, env_frames)
    t_roll = row("rollout+insert+stats", rollout, env_frames)
    t_mb = row("single minibatch update", minibatch)
    print(f"stage shares: rollout {t_roll / t_full:5.1%}  {mb} minibatches "
          f"{mb * t_mb / t_full:5.1%}  (sum "
          f"{(t_roll + mb * t_mb) / t_full:5.1%})")

    replay, generator = learner.replay, learner.generator
    t_sample = row("replay sample alone", lambda: replay.sample(
        held["state"].replay, generator, config.batch_size, 0))
    items = replay.sample(held["state"].replay, generator, config.batch_size,
                          0)[2]
    prev_actions, env_outputs, agent_actions = sac._time_major(
        (items.prev_actions, items.env_outputs, items.agent_actions))

    def loss():
        return sac.compute_loss(
            config, learner.agent, learner.target_agent,
            learner.entropy_cost, items.agent_state, prev_actions,
            env_outputs, agent_actions, generator)[0]

    def forward():
        # With autograd on: the loss takes dQ/da inside (the actor's
        # pathwise gradient); no backward of the loss runs.
        loss().detach()

    params = learner.parameters()
    row("loss forward only", forward)
    t_loss_bwd = row("loss fwd+bwd", lambda: torch.autograd.grad(
        loss(), params, allow_unused=True))
    with torch.no_grad():
        t_polyak = row("polyak target update alone", learner._move_target)
    print(f"minibatch shares: sample {t_sample / t_mb:5.1%}  loss fwd+bwd "
          f"{t_loss_bwd / t_mb:5.1%}  polyak {t_polyak / t_mb:5.1%}")
    return rows


def torso_curve(device, batches, iters):
    """Section 2's rows, by (pass, batch)."""
    from seed_rl_torch.models.atari import AtariConvTorso

    gen = torch.Generator().manual_seed(0)  # parameters, on the host
    data = _timing.Data(device)
    torso = AtariConvTorso(1, (84, 84), gen,
                           dtype=torch.bfloat16).to(device)
    params = list(torso.parameters())
    rows = {}
    for n in batches:
        x = data.frames((n, 84, 84, 1))
        ct = data.randn((n, 512))
        with torch.no_grad():
            rows[("fwd", n)] = _timing.timeit(
                f"torso fwd      batch {n:5d}", lambda x=x: torso(x), device,
                iters, n, 52)
        rows[("fwd+bwd", n)] = _timing.timeit(
            f"torso fwd+bwd  batch {n:5d}",
            lambda x=x, ct=ct: torch.autograd.grad(torso(x), params, ct),
            device, iters, n, 52)
    return rows


def main(argv=None):
    """Returns every section's rows, the accounting and the card."""
    args = parse_args(argv)
    device = _timing.device_from(args.device)
    card = _timing.card(device)
    B, T, MB = NUM_ENVS, UNROLL, MINIBATCHES
    env_frames = B * T
    learner, state, config = build(B, T, BATCH_SIZE, MB, device)
    print(f"== stage table (envs={B}, unroll={T}, batch={config.batch_size},"
          f" {MB} minibatches/step; {card}) ==")
    stages = stage_table(learner, state, config, device, args.iters,
                         env_frames)

    print("\n== AtariConvTorso (84x84x1 bf16) batch-efficiency ==")
    torso = torso_curve(device, [int(n) for n in
                                 args.torso_batches.split(",")], args.iters)

    fps = stages["full train step"].fps
    passes_per_mb = T * config.batch_size * 3 + (T + 1) * config.batch_size
    passes_per_step = env_frames + MB * passes_per_mb
    accounting = {"fps": fps,
                  "passes_per_env_frame": passes_per_step / env_frames,
                  "passes_per_sec": fps * passes_per_step / env_frames}
    print("\n== accounting ==")
    print(f"fps (env frames)                 {fps / 1e3:8.1f}k")
    print(f"torso frame-passes / env frame   "
          f"{accounting['passes_per_env_frame']:8.1f}")
    print(f"torso frame-passes / s           "
          f"{accounting['passes_per_sec'] / 1e6:8.2f}M")
    print("(the V-trace Atari line: profile_bench's full train_step fps x 4 "
          "forward-equivalents a frame)")

    print("\n== full-step sweep ==")
    sweep = {}
    for spec in args.sweep.split(","):
        envs, unroll = (int(x) for x in spec.split("x"))
        lrn, st, _ = build(envs, unroll, BATCH_SIZE, MB, device)
        held = {"state": st}

        def full(lrn=lrn, held=held):
            held["state"] = lrn.train_step(held["state"])[0]

        sweep[(envs, unroll)] = _timing.timeit(
            f"envs={envs:4d} unroll={unroll}", full, device, args.iters,
            envs * unroll, 52)
    print(card, flush=True)
    return {"stages": stages, "torso": torso, "accounting": accounting,
            "sweep": sweep, "card": card}


if __name__ == "__main__":
    main()
