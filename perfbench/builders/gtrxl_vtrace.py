"""Builds the V-trace cell of GTrXL on IMPALA's torso from the port's public
classes, and reads the program's side of the check.

As ``vtrace.py`` builds ImpalaDeep's, with the net ``ImpalaGTrXL`` at the
configuration's widths: the torso in its compute dtype, the core's
projections, attention and memory in the core's, the heads in float32. The
weights are drawn on the device from the run's seed (``harness/weights.py``)
in the reference's layout, the LayerNorms' gains and the gates' b_g set to
where they start (``reference.starting_values``), and copied into the net.

Set-up acts ``acting_steps`` env steps at the drawn weights through the
engine (its rollouts, on the card its CUDA graph's replays) before the
checked train steps: the checked unrolls then start with a memory that has
filled and wrapped, and an episode's end lies inside their queries'
windows.
"""

import functools

import torch

from perfbench import faults
from perfbench.counts import bounds, gtrxl
from perfbench.harness import weights
from perfbench.harness.cell import Cell
from perfbench.harness.recording import DTYPES, record, seeds, to_cpu

# The one pixel of each frame the set-up's unrolls keep: the reference
# reads an episode's seed from it and works the rest out.
PIXEL = (slice(None), slice(None), slice(0, 1), slice(0, 1))


def build(config, traffic, seed, device, reference) -> Cell:
    # Before anything is allocated: a port without the net stops here.
    from seed_rl_torch.models import ImpalaGTrXL

    from seed_rl_torch import distributions as pd
    from seed_rl_torch import optim
    from seed_rl_torch.agent import PolicyAgent
    from seed_rl_torch.agents import vtrace
    from seed_rl_torch.envs import BatchedEnv, synthetic
    from seed_rl_torch.rollout import RolloutEngine

    weight_seed, env_seed, engine_seed, learner_seed = seeds(seed, 4)
    env_knobs, net_knobs = dict(config["env"]), config["net"]
    env_class = getattr(synthetic, env_knobs.pop("class"))
    num_envs, unroll = traffic["num_envs"], traffic["unroll_length"]
    dtypes = config["compute_dtypes"]
    net = ImpalaGTrXL(
        net_knobs["num_actions"], tuple(net_knobs["frame_shape"]),
        num_layers=net_knobs["num_layers"],
        model_size=net_knobs["model_size"], num_heads=net_knobs["num_heads"],
        head_size=net_knobs["head_size"],
        memory_length=net_knobs["memory_length"],
        mlp_size=net_knobs["mlp_size"], gate_bias=net_knobs["gate_bias"],
        dtype=DTYPES[dtypes["torso"]], core_dtype=DTYPES[dtypes["core"]],
        device=device)
    env = BatchedEnv(env_class(**env_knobs), num_envs, device=device,
                     seed=env_seed)
    theta0 = reference.starting_values(config, weights.draw(
        reference.parameter_shapes(config), weight_seed, device))
    weights.load(net, theta0)
    agent = PolicyAgent(net, pd.CategoricalDistribution(
        net_knobs["num_actions"]))
    engine = RolloutEngine(env, agent, unroll, seed=engine_seed)
    knobs = config["learner"]
    learner = vtrace.VTraceLearner(
        engine, agent,
        vtrace.VTraceConfig(discounting=knobs["discounting"],
                            entropy_cost=knobs["entropy_cost"],
                            baseline_cost=knobs["baseline_cost"]),
        functools.partial(optim.ClippedAdam,
                          learning_rate=knobs["learning_rate"],
                          clip_norm=knobs["clip_norm"], b1=knobs["adam_b1"],
                          eps=knobs["adam_epsilon"]),
        seed=learner_seed)
    h, w, c = net_knobs["frame_shape"]
    trained = (unroll + 1) * num_envs
    convs = bounds.impala_convs(h, w, c)
    return Cell(
        learner=learner,
        state=learner.init(),
        frames_per_step=learner.frames_per_step,
        spans=[(engine, "rollout", "rollout"), (learner, "update", "update")],
        loss_key="losses/total",
        flops_per_step=gtrxl.step_flops(config, traffic),
        conv_seconds_per_step=(
            unroll * bounds.convs_seconds(convs, num_envs, train=False)
            + bounds.convs_seconds(convs, trained, train=True)),
        kernel_seconds_per_step={
            "vtrace_forward_kernel": bounds.vtrace_seconds(unroll, num_envs),
            gtrxl.ATTENTION_KERNELS: gtrxl.attention_seconds(config,
                                                             traffic)},
        theta0={n: t.detach().cpu() for n, t in theta0.items()},
        names=[n for n, _ in net.named_parameters()] + ["entropy_cost"],
        start=[p.detach().cpu().clone() for p in learner.parameters()],
        extra={"acting_steps": config["acting_steps"]},
    )


def _record_of(unroll, observation):
    ts = unroll.timesteps
    return {
        "prev_action": to_cpu(ts.prev_action),
        "reward": to_cpu(ts.env_output.reward),
        "done": to_cpu(ts.env_output.done),
        "observation": to_cpu(observation),
        "action": to_cpu(ts.agent_output.action),
    }


def check_steps(cell: Cell, steps: int):
    """Acts the set-up's ``acting_steps`` through the engine's rollouts,
    then drives the first ``steps`` train steps through ``train_many`` and
    reads the program's side of the check: the checked unrolls' behaviour
    logits and baselines, the memory the first two store (every layer's
    ring), B1's targets, each step's loss, the first gradient by leaf
    (from Adam's second moment) and each leaf's change. Keeps the core's
    counters as set-up leaves them (``extra["counters"]``). Returns (the
    program's readings, the reference's inputs), on the CPU."""
    from seed_rl_torch.agents import vtrace

    learner = cell.learner
    engine = learner.engine
    state = cell.state
    rollout, setup = state.rollout, []
    for _ in range(cell.extra["acting_steps"] // engine.unroll_length):
        rollout, unroll = engine.rollout(rollout)
        setup.append(_record_of(
            unroll, unroll.timesteps.env_output.observation[PIXEL]))
    state = state._replace(rollout=rollout)

    unrolls, targets, losses = [], [], []
    kernel = vtrace.vtrace_ops.from_importance_weights

    def recording_kernel(*args, **kwargs):
        returns = kernel(*args, **kwargs)
        targets.append(tuple(t.clone() for t in returns))
        return returns

    record(engine, "rollout", lambda out: unrolls.append(out[1]))
    vtrace.vtrace_ops.from_importance_weights = recording_kernel
    try:
        for k in range(steps):
            state, metrics = learner.train_many(state, 1)
            losses.append(metrics[cell.loss_key])
            if k == 0:
                second = [t.clone() for t in
                          learner.optimizer.state_dict()["exp_avg_sq"]]
    finally:
        del engine.rollout
        vtrace.vtrace_ops.from_importance_weights = kernel
    cell.state = state
    cell.extra["counters"] = {
        name: int(c) for name, c in learner.agent.net.counters.items()}
    b2 = 0.999
    grad_norms = {n: float((v.double() / (1 - b2)).sum().sqrt())
                  for n, v in zip(cell.names, second)}
    change_norms = {
        n: float((p.detach().cpu().double() - p0.double()).norm())
        for n, p, p0 in zip(cell.names, learner.parameters(), cell.start)}
    program = {
        "logits": [to_cpu(u.timesteps.agent_output.policy_logits)
                   for u in unrolls],
        "baseline": [to_cpu(u.timesteps.agent_output.baseline)
                     for u in unrolls],
        "memory": [{"rings": to_cpu(u.agent_state.memory)}
                   for u in unrolls[:2]],
        "vtrace": [to_cpu(t) for t in targets],
        "loss": [float(x) for x in losses],
        "grad_norms": grad_norms,
        "change_norms": change_norms,
    }
    inputs = {
        "theta0": cell.theta0,
        "acting_steps": cell.extra["acting_steps"],
        "setup": setup,
        "unrolls": [_record_of(u, u.timesteps.env_output.observation)
                    for u in unrolls],
    }
    return program, inputs


def _altered_targets(kernel):
    """B1 with its last row of ``vs`` raised by 1."""
    def altered(*args, **kwargs):
        returns = kernel(*args, **kwargs)
        returns.vs[-1] += 1.0
        return returns
    return altered


def no_reset(cell):
    """The core blind to ``done``: the previous episode's keys stay
    visible, in acting and in learning."""
    net = cell.learner.agent.net
    for method in ("_act", "_segment"):
        original = getattr(net, method)
        setattr(net, method, functools.partial(
            lambda original, e, done, state: original(
                e, torch.zeros_like(done), state), original))
    return lambda: (delattr(net, "_act"), delattr(net, "_segment"))


def ring_shift(cell):
    """Each acting step's row moved one slot on in the ring once the step
    has attended, the slot it was written to given back what it held."""
    net = cell.learner.agent.net
    original = net._act

    def shifted(e, done, state):
        rows = torch.arange(e.shape[0], device=e.device)
        slot = state.time % net.ring
        held = [memory[rows, slot].clone() for memory in state.memory]
        out = original(e, done, state)
        for memory, old in zip(state.memory, held):
            memory[rows, (slot + 1) % net.ring] = memory[rows, slot]
            memory[rows, slot] = old
        return out

    net._act = shifted
    return lambda: delattr(net, "_act")


FAULTS = {
    "frozen": faults.frozen,
    "half_batch": faults.half_batch("seed_rl_torch.agents.vtrace"),
    "altered": faults.replace("seed_rl_torch.ops.cuda.vtrace_kernel",
                              "from_importance_weights", _altered_targets),
    "no_reset": no_reset,
    "ring_shift": ring_shift,
}
