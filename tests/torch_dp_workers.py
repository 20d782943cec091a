"""What the ranks of the data-parallel tests run (tests/test_torch_parallel.py,
tests/test_torch_multihost.py).

``parallel.spawn`` runs rank 0 in the test's process and the other ranks in
fresh processes that import this module by name, so it imports no JAX and
nothing of the JAX package (the tests compute JAX's side themselves and
pass numpy arrays in). Each function takes the rank's ``Mesh`` first (None
for a one-device run) and returns numpy summaries that pickle.

Run as a script, ``python tests/torch_dp_workers.py <process_id> <port>``
is one process of the two-process group of test_torch_multihost.py.
"""

import functools
import os
import sys

import torch
import torch.utils._pytree as pytree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from seed_rl_torch import optim, train  # noqa: E402
from seed_rl_torch.parallel import (  # noqa: E402
    DistributedLearner,
    collectives,
)
from seed_rl_torch.utils import episode_stats  # noqa: E402


def _np(tree):
    return pytree.tree_map(
        lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
        else t, tree)


def _inner(learner):
    return getattr(learner, "learner", learner)


def _generators(learner):
    engine = learner.engine
    return [g.get_state().numpy() for g in (
        engine.env.generator, engine.generator, learner.generator)]


def summary(learner, state, metrics, mesh=None):
    """What a rank holds after a run: the replicated tensors (parameters,
    target parameters, optimizer moments, statistics, priorities,
    generators), its share (env count, return accumulators, replay slots)
    and the global episode window and metrics."""
    inner = _inner(learner)
    out = dict(
        params=_np([p for p in inner.parameters()]),
        opt=_np(pytree.tree_leaves(inner.optimizer.state_dict())),
        metrics={k: float(v) for k, v in metrics.items()},
        step=state.step,
        window=episode_stats.window(state.stats, inner.mesh),
        return_acc=_np(state.stats.return_acc),
        num_envs=inner.engine.env.num_envs,
        generators=_generators(inner),
        obs_norm=_np(pytree.tree_leaves(getattr(inner.agent, "obs_norm",
                                                None) or ())),
    )
    target = getattr(inner, "target_net", None) or getattr(
        getattr(inner, "target_agent", None), "net", None)
    if target is not None:
        out["target"] = _np(list(target.parameters()))
    if hasattr(state, "norm_state"):
        out["norm_state"] = _np(pytree.tree_leaves(state.norm_state))
    if hasattr(state, "replay"):
        out["priorities"] = _np(state.replay.priorities)
        out["slots"] = pytree.tree_leaves(state.replay.buffer)[0].shape[0]
        out["num_inserted"] = state.replay.num_inserted
    if hasattr(state, "eval_stats"):
        out["eval_window"] = episode_stats.window(state.eval_stats,
                                                  inner.mesh)
        out["eval_return_acc"] = _np(state.eval_stats.return_acc)
    return out


def cli(mesh, argv):
    """``train.main`` on this rank (``--num_replicas`` = the mesh's size);
    the summary of its learner."""
    learner, state, metrics = train.main(argv, mesh=mesh)
    return summary(learner, state, metrics, mesh)


def jobs(mesh, todo):
    """Several of this module's functions, ``[(name, argument), ...]``, on
    one process group."""
    module = sys.modules[__name__]
    return [getattr(module, name)(mesh, arg) for name, arg in todo]


def gathers(mesh, _):
    """``Mesh.gather_to_host`` of uneven parts (rank 0 holds 3 rows, rank 1
    one) and the devices of a V-trace checkpoint's per-env leaves on this
    rank."""
    from seed_rl_torch import distributions as tpd
    from seed_rl_torch.agent import PolicyAgent
    from seed_rl_torch.agents import vtrace
    from seed_rl_torch.envs import BatchedEnv, ToyEnv
    from seed_rl_torch.models import MLPAndLSTM
    from seed_rl_torch.rollout import RolloutEngine

    rows = 3 if mesh.rank == 0 else 1
    x = torch.arange(rows * 2, dtype=torch.float32).reshape(rows, 2).add(
        10 * mesh.rank)
    flags = torch.arange(rows) % 2 == mesh.rank
    gathered = [mesh.gather_to_host(t, dim) for t, dim in (
        (x, 0), (x.T, 1), (flags, 0))]
    net = MLPAndLSTM(6, 4, mlp_sizes=(8,), lstm_sizes=(4,), device="cpu")
    agent = PolicyAgent(net, tpd.NormalTanhDistribution(3))
    learner = DistributedLearner(vtrace.VTraceLearner(
        RolloutEngine(BatchedEnv(ToyEnv(), 4, device="cpu", mesh=mesh),
                      agent, 2), agent, vtrace.VTraceConfig(),
        functools.partial(optim.ClippedAdam, learning_rate=1e-3)), mesh)
    state = learner.init()
    tree = learner.checkpoint_state(state)
    layout = learner.checkpoint_layout(state)
    return dict(
        gathered=[g.numpy() if g.device.type == "cpu"
                  else (g.device.type, tuple(g.shape)) for g in gathered],
        rollout=sorted({(t.device.type, tuple(t.shape)) for t in
                        pytree.tree_leaves(tree["rollout"])}),
        layout=sorted({(t.device.type, tuple(t.shape)) for t in
                       pytree.tree_leaves(layout["rollout"])}))


def uint16_frames(mesh, spec):
    """C6 across ranks: this rank's half of ``spec["frames"]`` (uint16, in
    rank order) gathered by ``all_gather`` and ``gather_to_host``, then
    inserted into a replay sharded by slot and sampled at
    ``spec["indices"]``; the sample's frames, as int16 bits."""
    from seed_rl_torch.replay import PrioritizedReplay

    frames = torch.from_numpy(spec["frames"]).view(torch.uint16)
    mine = frames.chunk(mesh.size)[mesh.rank]
    gathered = mesh.all_gather(mine)
    hosted = mesh.gather_to_host(mine)
    replay = PrioritizedReplay(spec["size"], 0.6, mesh=mesh)
    state = replay.init_state(mine[0])
    for _ in range(2):  # rank 0's slots, then rank 1's
        state, _ = replay.insert(state, mine,
                                 torch.ones(mine.shape[0]).add(mesh.rank))
    _, _, items = replay.sample(state, None, len(spec["indices"]), 0.9,
                                indices=torch.from_numpy(spec["indices"]))
    return dict(
        dtypes=[str(t.dtype) for t in (gathered, items)],
        gathered=gathered.view(torch.int16).numpy(),
        hosted=(hosted.view(torch.int16).numpy() if mesh.rank == 0
                else str(hosted.device)),
        sampled=items.view(torch.int16).numpy())


def _unroll(tree, env_ids):
    """A numpy unroll (from JAX) as tensors, this rank's env columns."""
    from seed_rl_torch.rollout import Timestep, Unroll
    from seed_rl_torch.types import AgentOutput, EnvOutput, QAgentOutput

    agent_state, prev, env_output, agent_output, q = tree
    out_type = QAgentOutput if q else AgentOutput
    return Unroll(
        agent_state=pytree.tree_map(lambda a: torch.tensor(a)[env_ids],
                                    agent_state),
        timesteps=Timestep(
            prev_action=torch.tensor(prev)[:, env_ids],
            env_output=EnvOutput(*(torch.tensor(a)[:, env_ids]
                                   for a in env_output)),
            agent_output=out_type(*(torch.tensor(a)[:, env_ids]
                                    for a in agent_output)),
        ))


def vtrace_update(mesh, spec):
    """One V-trace update on this rank's columns of a JAX unroll, from the
    JAX learner's parameters, with JAX's global entropy noise."""
    from seed_rl_torch import distributions as tpd
    from seed_rl_torch.agent import PolicyAgent
    from seed_rl_torch.agents import vtrace
    from seed_rl_torch.envs import BatchedEnv, ToyEnv
    from seed_rl_torch.models import MLPAndLSTM
    from seed_rl_torch.rollout import RolloutEngine

    net = MLPAndLSTM(6, 4, mlp_sizes=(16,), lstm_sizes=(8,), device="cpu")
    net.load_state_dict({k: torch.tensor(v)
                         for k, v in spec["state_dict"].items()})
    agent = PolicyAgent(net, tpd.NormalTanhDistribution(3))
    env = BatchedEnv(ToyEnv(horizon=3), spec["num_envs"], device="cpu",
                     mesh=mesh)
    learner = vtrace.VTraceLearner(
        RolloutEngine(env, agent, spec["unroll_length"]), agent,
        vtrace.VTraceConfig(**spec["config"]),
        functools.partial(optim.ClippedAdam, learning_rate=spec["lr"],
                          clip_norm=spec["clip_norm"]))
    with torch.no_grad():
        learner.entropy_cost.copy_(torch.tensor(spec["entropy_cost"]))
    with collectives.over(mesh):
        state, metrics = learner.update(
            learner.init(), _unroll(spec["unroll"], env.env_ids),
            entropy_noise=torch.tensor(spec["noise"]))
    return dict(
        params={k: v.detach().numpy() for k, v in net.state_dict().items()},
        entropy_cost=float(learner.entropy_cost.detach()),
        metrics={k: float(v) for k, v in metrics.items()},
        window=episode_stats.window(state.stats, learner.mesh),
        return_acc=state.stats.return_acc.numpy(),
    )


def r2d2_batch(mesh, spec):
    """One R2D2 batch on a JAX replay split by rank (each rank holds its
    ring slots), at JAX's indices, from the JAX learner's parameters."""
    from seed_rl_torch.agents import r2d2
    from seed_rl_torch.envs import BatchedEnv, DiscreteMatchEnv
    from seed_rl_torch.models import VectorDuelingDQNNet
    from seed_rl_torch.replay import ReplayState
    from seed_rl_torch.rollout import RolloutEngine
    from seed_rl_torch.types import EnvOutput, QAgentOutput

    num_envs, num_eval = spec["num_envs"], spec["config"]["num_eval_envs"]
    env = BatchedEnv(DiscreteMatchEnv(n_actions=4, horizon=10), num_envs,
                     device="cpu", mesh=mesh)
    net = VectorDuelingDQNNet(4, 4, device="cpu", **spec["net"])
    net.load_state_dict({k: torch.tensor(v)
                         for k, v in spec["params"].items()})
    epsilons = torch.cat([r2d2.training_env_epsilons(num_envs - num_eval),
                          torch.full((num_eval,), 1e-3)])[env.env_ids]
    agent = r2d2.R2D2Agent(net, epsilons)
    config = r2d2.R2D2Config(**spec["config"])
    learner = r2d2.R2D2Learner(
        RolloutEngine(env, agent, spec["unroll_length"],
                      num_overlapping_steps=config.burn_in),
        agent, config,
        functools.partial(optim.ClippedAdam, learning_rate=spec["lr"],
                          clip_norm=spec["clip_norm"]))
    learner.target_net.load_state_dict(
        {k: torch.tensor(v) for k, v in spec["target_params"].items()})
    slots = learner.replay.slots
    agent_state, prev, env_outputs, agent_outputs = spec["buffer"]
    buffer = r2d2.StoredUnroll(
        agent_state=pytree.tree_map(lambda a: torch.tensor(a[slots]),
                                    agent_state),
        prev_actions=torch.tensor(prev[slots]),
        env_outputs=EnvOutput(*(torch.tensor(a[slots])
                                for a in env_outputs)),
        agent_outputs=QAgentOutput(*(torch.tensor(a[slots])
                                     for a in agent_outputs)))
    with collectives.over(mesh):
        state = learner.init()
        state = state._replace(replay=ReplayState(
            buffer=buffer, priorities=torch.tensor(spec["priorities"]),
            insert_index=spec["insert_index"],
            num_inserted=spec["num_inserted"]))
        state, logs = learner.train_on_batch(
            state, indices=torch.tensor(spec["indices"]))
    return dict(
        params={k: v.detach().numpy() for k, v in net.state_dict().items()},
        logs={k: float(v) for k, v in logs.items()},
        priorities=state.replay.priorities.numpy(),
        slots=slots.stop - slots.start,
    )


def multihost(process_id: int, port: int):
    """One process of a two-process group over gloo (``init_multi_host``):
    V-trace and R2D2 through the CLI's learners, and the metrics printed
    for the test to compare across the processes."""
    from seed_rl_torch.parallel import init_multi_host, make_mesh

    torch.set_num_threads(1)
    init_multi_host(f"localhost:{port}", 2, process_id, backend="gloo",
                    timeout_secs=120)
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    common = ["--device=cpu", "--num_replicas=2", "--log_every_steps=1",
              "--steps_per_call=1"]
    learner, state, metrics = train.main(
        ["--agent=vtrace", "--env=toy", "--num_envs=16",
         "--unroll_length=4", "--total_environment_frames=192"] + common,
        mesh=mesh)
    assert isinstance(learner, DistributedLearner)
    print("METRICS", process_id, repr(float(metrics["losses/total"])),
          repr(float(metrics["policy/entropy"])), state.step, flush=True)
    learner, state, metrics = train.main(
        ["--agent=r2d2", "--env=discrete_match", "--num_envs=16",
         "--unroll_length=4", "--burn_in=1", "--n_steps=2",
         "--replay_buffer_size=64", "--replay_buffer_min_size=16",
         "--batch_size=8", "--total_environment_frames=128"] + common,
        mesh=mesh)
    print("R2D2_METRICS", process_id, repr(float(metrics["losses/td"])),
          repr(float(metrics["replay/sampled_priority_mean"])),
          repr(float(metrics["replay/importance_weight_mean"])),
          state.step, flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    multihost(int(sys.argv[1]), int(sys.argv[2]))
