"""Builds a V-trace cell from the port's public classes, and reads the
program's side of the check.

The configuration names the env (a class of ``seed_rl_torch.envs.synthetic``),
the net (a class of ``seed_rl_torch.models``), the compute dtypes and the
learner's knobs; the traffic mix the envs and the unroll length. The
weights are drawn on the device from the run's seed
(``harness/weights.py``) in the reference's layout and copied into the
net before the learner is made.
"""

import functools

from perfbench import faults
from perfbench.counts import bounds, flops
from perfbench.harness import weights
from perfbench.harness.recording import DTYPES, record, seeds, to_cpu
from perfbench.harness.cell import Cell

def build(config, traffic, seed, device, reference) -> Cell:
    from seed_rl_torch import distributions as pd
    from seed_rl_torch import models, optim
    from seed_rl_torch.agent import PolicyAgent
    from seed_rl_torch.agents import vtrace
    from seed_rl_torch.envs import BatchedEnv, synthetic
    from seed_rl_torch.rollout import RolloutEngine

    weight_seed, env_seed, engine_seed, learner_seed = seeds(seed, 4)
    env_knobs, net_knobs = dict(config["env"]), config["net"]
    env_class = getattr(synthetic, env_knobs.pop("class"))
    num_envs, unroll = traffic["num_envs"], traffic["unroll_length"]
    env = BatchedEnv(env_class(**env_knobs), num_envs, device=device,
                     seed=env_seed)
    dist = pd.CategoricalDistribution(net_knobs["num_actions"])
    net = getattr(models, net_knobs["class"])(
        net_knobs["num_actions"], tuple(net_knobs["frame_shape"]),
        lstm_size=net_knobs["lstm"],
        dtype=DTYPES[config["compute_dtypes"]["torso"]], device=device)
    theta0 = weights.draw(reference.parameter_shapes(config), weight_seed,
                          device)
    weights.load(net, theta0)
    agent = PolicyAgent(net, dist)
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
    cell = Cell(
        learner=learner,
        state=learner.init(),
        frames_per_step=learner.frames_per_step,
        spans=[(engine, "rollout", "rollout"), (learner, "update", "update")],
        loss_key="losses/total",
        # A rollout acts on every frame once (forward); the update trains
        # on T + 1 timesteps a column (forward and backward: 3 forwards).
        flops_per_step=flops.impala_deep(net_knobs["num_actions"], h, w, c,
                                         net_knobs["lstm"])
        * (unroll * num_envs + 3 * trained),
        conv_seconds_per_step=(
            unroll * bounds.convs_seconds(bounds.impala_convs(h, w, c),
                                          num_envs, train=False)
            + bounds.convs_seconds(bounds.impala_convs(h, w, c), trained,
                                   train=True)),
        kernel_seconds_per_step={
            "vtrace_forward_kernel": bounds.vtrace_seconds(unroll, num_envs)},
        theta0={n: t.detach().cpu() for n, t in theta0.items()},
        names=[n for n, _ in net.named_parameters()] + ["entropy_cost"],
        start=[p.detach().cpu().clone() for p in learner.parameters()],
    )
    return cell


def check_steps(cell: Cell, steps: int):
    """Drives the first ``steps`` train steps through the window's own call
    (``train_many``) and reads the program's side of the check: the
    unrolls' behaviour logits, baselines and carried LSTM state, B1's
    targets, each step's loss, the first gradient by leaf (from Adam's
    second moment after one step) and each leaf's change after the last.
    Returns (the program's readings, the reference's inputs), on the CPU.
    """
    from seed_rl_torch.agents import vtrace

    learner = cell.learner
    unrolls, targets, losses = [], [], []
    kernel = vtrace.vtrace_ops.from_importance_weights

    def recording_kernel(*args, **kwargs):
        returns = kernel(*args, **kwargs)
        targets.append(tuple(t.clone() for t in returns))
        return returns

    record(learner.engine, "rollout", lambda out: unrolls.append(out[1]))
    vtrace.vtrace_ops.from_importance_weights = recording_kernel
    try:
        state = cell.state
        for k in range(steps):
            state, metrics = learner.train_many(state, 1)
            losses.append(metrics[cell.loss_key])
            if k == 0:
                second = [t.clone() for t in
                          learner.optimizer.state_dict()["exp_avg_sq"]]
    finally:
        del learner.engine.rollout
        vtrace.vtrace_ops.from_importance_weights = kernel
    cell.state = state
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
        "core": [to_cpu(u.agent_state[0]) for u in unrolls],
        "vtrace": [to_cpu(t) for t in targets],
        "loss": [float(x) for x in losses],
        "grad_norms": grad_norms,
        "change_norms": change_norms,
    }
    inputs = {
        "theta0": cell.theta0,
        "unrolls": [{
            "prev_action": to_cpu(u.timesteps.prev_action),
            "reward": to_cpu(u.timesteps.env_output.reward),
            "done": to_cpu(u.timesteps.env_output.done),
            "observation": to_cpu(u.timesteps.env_output.observation),
            "action": to_cpu(u.timesteps.agent_output.action),
        } for u in unrolls],
    }
    return program, inputs


def _altered_targets(kernel):
    """B1 with its last row of ``vs`` raised by 1."""
    def altered(*args, **kwargs):
        returns = kernel(*args, **kwargs)
        returns.vs[-1] += 1.0
        return returns
    return altered


FAULTS = {
    "frozen": faults.frozen,
    "half_batch": faults.half_batch("seed_rl_torch.agents.vtrace"),
    "altered": faults.replace("seed_rl_torch.ops.cuda.vtrace_kernel",
                              "from_importance_weights", _altered_targets),
}
