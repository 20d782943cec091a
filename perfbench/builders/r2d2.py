"""Builds an R2D2 cell from the port's public classes, fills its replay,
and reads the program's side of the check.

The configuration names the env (a class of ``seed_rl_torch.envs.synthetic``),
the net (``DuelingLSTMDQNNet``), its compute dtypes, the replay and the
learner's knobs; the traffic mix the envs (eval envs among them), the unroll
and burn-in lengths and the batches a step. Set-up fills the replay to
capacity, as a long run holds it: the reference minimum of real rollouts
(``replay_buffer_min_size`` items, through ``warmup_step``), then those
items inserted again in order, with their own initial priorities, until
every slot is full.
"""

import functools

import torch
import torch.utils._pytree as pytree

from perfbench import faults
from perfbench.counts import bounds, flops
from perfbench.harness import weights
from perfbench.harness.recording import DTYPES, record, seeds, to_cpu
from perfbench.harness.cell import Cell


def build(config, traffic, seed, device, reference) -> Cell:
    from seed_rl_torch import models, optim
    from seed_rl_torch.agents import r2d2
    from seed_rl_torch.envs import BatchedEnv, synthetic
    from seed_rl_torch.rollout import RolloutEngine

    weight_seed, env_seed, engine_seed, learner_seed = seeds(seed, 4)
    env_knobs, net_knobs = dict(config["env"]), config["net"]
    env_class = getattr(synthetic, env_knobs.pop("class"))
    num_envs, num_eval = traffic["num_envs"], traffic["num_eval_envs"]
    unroll, burn_in = traffic["unroll_length"], traffic["burn_in"]
    env = BatchedEnv(env_class(**env_knobs), num_envs, device=device,
                     seed=env_seed)
    dtypes = config["compute_dtypes"]
    net = getattr(models, net_knobs["class"])(
        net_knobs["num_actions"], tuple(net_knobs["frame_shape"]),
        stack_size=net_knobs["stack_size"], lstm_size=net_knobs["lstm"],
        dtype=DTYPES[dtypes["torso"]], core_dtype=DTYPES[dtypes["core"]],
        device=device)
    theta0 = weights.draw(reference.parameter_shapes(config), weight_seed,
                          device)
    weights.load(net, theta0)
    knobs = config["learner"]
    r2d2_config = r2d2.R2D2Config(
        discounting=knobs["discounting"], n_steps=knobs["n_steps"],
        burn_in=burn_in,
        importance_sampling_exponent=knobs["importance_sampling_exponent"],
        priority_exponent=knobs["priority_exponent"],
        replay_buffer_size=config["replay"]["size"],
        replay_buffer_min_size=config["replay"]["min_size"],
        batch_size=knobs["batch_size"],
        train_batches_per_step=traffic["batches_per_step"],
        update_target_every_n_step=knobs["update_target_every_n_step"],
        eval_epsilon=knobs["eval_epsilon"], num_eval_envs=num_eval,
        value_function_rescaling_epsilon=knobs["rescaling_epsilon"])
    epsilons = torch.cat([
        r2d2.training_env_epsilons(num_envs - num_eval, device),
        torch.full((num_eval,), knobs["eval_epsilon"], device=device)])
    agent = r2d2.R2D2Agent(net, epsilons)
    engine = RolloutEngine(env, agent, unroll, num_overlapping_steps=burn_in,
                           seed=engine_seed)
    learner = r2d2.R2D2Learner(
        engine, agent, r2d2_config,
        functools.partial(optim.ClippedAdam,
                          learning_rate=knobs["learning_rate"],
                          clip_norm=knobs["clip_norm"], b1=knobs["adam_b1"],
                          eps=knobs["adam_epsilon"]),
        seed=learner_seed)

    # The fill: the real rollouts' items are inserted again, in order, from
    # the slots they went to, until every slot is full.
    training = num_envs - num_eval
    state = learner.init()
    replay, records, priorities = learner.replay, [], []
    record(engine, "rollout",
            lambda out: records.append(_unrollrecord(out[1])))
    record(replay, "insert", lambda out, values, p: priorities.append(
        to_cpu(p)), with_args=True)
    try:
        while state.replay.num_inserted < r2d2_config.replay_buffer_min_size:
            state = learner.warmup_step(state)
    finally:
        del engine.rollout, replay.insert
    real = state.replay.num_inserted
    while state.replay.num_inserted < replay.size:
        done = state.replay.num_inserted
        start = (done - real) % real
        n = min(training, replay.size - done, real - start)
        values = pytree.tree_map(lambda t: t[start:start + n],
                                 state.replay.buffer)
        state = state._replace(replay=replay.insert(
            state.replay, values,
            state.replay.priorities[start:start + n].clone())[0])

    batches, batch = traffic["batches_per_step"], knobs["batch_size"]
    h, w = net_knobs["frame_shape"]
    stack, actions = net_knobs["stack_size"], net_knobs["num_actions"]
    fwd = flops.dueling_lstm_dqn_net(actions, net_knobs["lstm"], stack)
    convs = bounds.nature_convs(h, w, stack)
    suffix = unroll + 1
    cell = Cell(
        learner=learner,
        state=state,
        frames_per_step=learner.frames_per_step,
        spans=[(engine, "rollout", "rollout"), (replay, "insert", "insert"),
               (replay, "sample", "sample"),
               (learner, "train_on_batch", "update")],
        loss_key="losses/td",
        # A rollout acts on every frame (forward); a batch runs its burn-in
        # through the online and target nets (2 forwards) and trains on
        # the rest (online forward and backward, target forward: 4).
        flops_per_step=fwd * (unroll * num_envs
                              + batches * batch * (2 * burn_in + 4 * suffix)),
        conv_seconds_per_step=(
            unroll * bounds.convs_seconds(convs, num_envs, train=False)
            + batches * (bounds.convs_seconds(convs, 2 * burn_in * batch,
                                              train=False)
                         + bounds.convs_seconds(convs, suffix * batch,
                                                train=True)
                         + bounds.convs_seconds(convs, suffix * batch,
                                                train=False))),
        kernel_seconds_per_step={
            "nstep_forward_kernel": bounds.nstep_seconds(suffix, training)
            + batches * bounds.nstep_seconds(suffix, batch)},
        theta0={n: t.detach().cpu() for n, t in theta0.items()},
        names=[n for n, _ in net.named_parameters()],
        start=[p.detach().cpu().clone() for p in learner.parameters()],
        extra={"fill_unrolls": records, "fill_priorities": priorities,
               "fill": {"real": real, "per_insert": training,
                        "size": replay.size},
               "adam_b1": knobs["adam_b1"]},
    )
    return cell


def _unrollrecord(unroll):
    """An unroll's leaves on the CPU: its timesteps [T, B] and the state it
    starts from (the LSTM carry and the frame-stacking history)."""
    ts = unroll.timesteps
    (c, h), = unroll.agent_state.core_state
    return {
        "c": to_cpu(c), "h": to_cpu(h),
        "frames": to_cpu(unroll.agent_state.frame_stacking_state),
        "prev_action": to_cpu(ts.prev_action),
        "reward": to_cpu(ts.env_output.reward),
        "done": to_cpu(ts.env_output.done),
        "observation": to_cpu(ts.env_output.observation),
        "abandoned": to_cpu(ts.env_output.abandoned),
        "episode_step": to_cpu(ts.env_output.episode_step),
        "action": to_cpu(ts.agent_output.action),
        "q_values": to_cpu(ts.agent_output.q_values),
    }


# The leaves of a replay item in the order the check compares them.
ITEM_LEAVES = ("c", "h", "frames", "prev_action", "reward", "done",
               "observation", "abandoned", "episode_step", "action",
               "q_values")


def item_leaves(items):
    """A sampled batch (``StoredUnroll``, item-major) as ``ITEM_LEAVES``."""
    (c, h), = items.agent_state.core_state
    env, out = items.env_outputs, items.agent_outputs
    return [c, h, items.agent_state.frame_stacking_state, items.prev_actions,
            env.reward, env.done, env.observation, env.abandoned,
            env.episode_step, out.action, out.q_values]


def check_steps(cell: Cell, steps: int):
    """Drives the first ``steps`` train steps through the window's own call
    (``train_many``) and reads the program's side of the check: every
    unroll's behaviour Q values and carried state, each insert's initial
    priorities (B2), each batch's sampled indices, importance weights and
    items, its written-back priorities (B2) and loss, each step's loss, the
    first gradient (Adam's first moment after the first batch over 1 - β1)
    and its norm by leaf (from the second moment), and each leaf's change
    after the last step. Returns (the
    program's readings, the reference's inputs), on the CPU.
    """
    learner, replay, engine = cell.learner, cell.learner.replay, None
    engine = learner.engine
    unrolls, inserted, samples, written, losses = [], [], [], [], []
    batch_losses = []
    first, second = [], []
    record(engine, "rollout", lambda out: unrolls.append(out[1]))
    record(replay, "insert",
            lambda out, values, priorities: inserted.append(to_cpu(priorities)),
            with_args=True)
    record(replay, "sample", lambda out: samples.append(
        (to_cpu(out[0]), to_cpu(out[1]), [to_cpu(t) for t in item_leaves(out[2])])))
    record(learner, "optimize", lambda out: (
        written.append(to_cpu(out[0])),
        batch_losses.append(float(out[1]["losses/td"]))))

    def first_moment(out):
        if not second:
            moments = learner.optimizer.state_dict()
            second.extend(t.detach().cpu().clone()
                          for t in moments["exp_avg_sq"])
            first.extend(t.detach().cpu().clone()
                         for t in moments["exp_avg"])
    record(learner, "train_on_batch", first_moment)
    try:
        state = cell.state
        for _ in range(steps):
            state, metrics = learner.train_many(state, 1)
            losses.append(float(metrics[cell.loss_key]))
    finally:
        del (engine.rollout, replay.insert, replay.sample, learner.optimize,
             learner.train_on_batch)
    cell.state = state
    b1, b2 = cell.extra["adam_b1"], 0.999
    grad_norms = {n: float((v.double() / (1 - b2)).sum().sqrt())
                  for n, v in zip(cell.names, second)}
    change_norms = {
        n: float((p.detach().cpu().double() - p0.double()).norm())
        for n, p, p0 in zip(cell.names, learner.parameters(), cell.start)}
    records = cell.extra["fill_unrolls"] + [
        _unrollrecord(u) for u in unrolls]
    program = {
        "q": [r["q_values"] for r in records],
        "core": [(r["c"], r["h"]) for r in records],
        "frames": [r["frames"] for r in records],
        "insert": cell.extra["fill_priorities"] + inserted,
        "weights": [w for _, w, _ in samples],
        "items": [items for _, _, items in samples],
        "written": written,
        "batch_loss": batch_losses,
        "loss": losses,
        "grad_norms": grad_norms,
        "grad": {n: m / (1 - b1) for n, m in zip(cell.names, first)},
        "change_norms": change_norms,
    }
    inputs = {
        "theta0": cell.theta0,
        "unrolls": records,
        "fill": cell.extra["fill"],
        "priorities": {"insert": cell.extra["fill_priorities"] + inserted,
                       "written": written},
        "indices": [i for i, _, _ in samples],
        "batches_per_step": learner.config.train_batches_per_step,
    }
    return program, inputs


def _altered_priorities(kernel):
    """B2 with every priority it returns raised by 1."""
    def altered(*args, **kwargs):
        loss, priorities = kernel(*args, **kwargs)
        return loss, priorities + 1.0
    return altered


def _unweighted(cell):
    """The replay's importance weights all set to 1 where they are
    produced, as if prioritized sampling went uncorrected."""
    replay = cell.learner.replay
    sample = replay.sample

    def unweighted(*args, **kwargs):
        indices, weights, items = sample(*args, **kwargs)
        return indices, torch.ones_like(weights), items

    replay.sample = unweighted
    return lambda: replay.__dict__.pop("sample", None)


FAULTS = {
    "frozen": faults.frozen,
    "unweighted": _unweighted,
    "half_batch": faults.half_batch("seed_rl_torch.agents.r2d2"),
    "altered": faults.replace("seed_rl_torch.ops.cuda.nstep_kernel",
                              "td_loss_and_priorities_dispatch",
                              _altered_priorities),
}
