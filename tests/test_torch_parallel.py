"""Data-parallel scale-out (seed_rl_torch.parallel) on the CPU over gloo.

Mirrors tests/test_parallel.py. The JAX package's ``DistributedLearner`` is
one global-array program whose result equals the single-device program's;
the port's two ranks must equal its one-rank run, and through it the JAX
package:
- V-trace, R2D2 (n-step and Retrace, with eval envs that split unevenly
  over the ranks; from Catch frames), PPO (``split`` with GAE; V-MPO with
  PopArt on a recurrent net; V-trace advantages with AWR in ``repeat``
  mode; from Catch frames) and SAC
  (continuous with a tuned entropy cost; discrete with HER on
  ``bit_flipping``; with observation normalization) through
  ``train.main(argv, mesh=...)`` on two ranks against ``--num_replicas=1``:
  parameters, target parameters, optimizer moments, metrics, replay
  priorities, observation and PopArt statistics and episode statistics
  within rtol 1e-4 / atol 1e-5 (sums over the ranks run in another
  order); the two ranks' replicated tensors (parameters, moments,
  priorities, generators, statistics) bitwise equal; each rank holding
  B/N envs, S/N replay slots and its envs' return accumulators;
- directly against JAX: the two ranks' V-trace update on a JAX unroll
  split by env, and their R2D2 batch on a JAX replay split by slot at
  JAX's indices, equal ``seed_rl_tpu``'s update (which tests/
  test_parallel.py holds equal to its ``DistributedLearner``);
- the draws by global env id, the collectives outside a mesh, the mesh's
  refusals.

Every two-rank job of this file runs on one process group (one spawn, a
module fixture); the ranks run ``tests/torch_dp_workers.py``, which imports
no JAX.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import torch_dp_workers as workers
from seed_rl_tpu import distributions as jpd
from seed_rl_tpu.agent import PolicyAgent as JaxPolicyAgent
from seed_rl_tpu.agents import r2d2 as jax_r2d2
from seed_rl_tpu.agents import vtrace as jax_vtrace
from seed_rl_tpu.envs import BatchedEnv as JaxBatchedEnv
from seed_rl_tpu.envs import ToyEnv as JaxToyEnv
from seed_rl_tpu.envs import toy as jax_toy
from seed_rl_tpu.models import MLPAndLSTM as JaxMLPAndLSTM
from seed_rl_tpu.models.dueling_mlp import (
    VectorDuelingDQNNet as JaxVectorDuelingDQNNet,
)
from seed_rl_tpu.rollout import RolloutEngine as JaxRolloutEngine
from seed_rl_torch import parallel
from seed_rl_torch.agents import r2d2
from seed_rl_torch.envs import BatchedEnv, ToyEnv
from seed_rl_torch.models import MLPAndLSTM, VectorDuelingDQNNet, convert
from seed_rl_torch.parallel import collectives, draws

TOL = dict(rtol=1e-4, atol=1e-5)
COMMON = ["--device=cpu", "--steps_per_call=1", "--log_every_steps=3"]
CLI_CASES = {
    "vtrace-toy-lstm": [
        "--agent=vtrace", "--env=toy", "--num_envs=16", "--unroll_length=4",
        "--total_environment_frames=256"],
    "vtrace-normalized": [
        "--agent=vtrace", "--env=toy", "--num_envs=16", "--unroll_length=4",
        "--normalize_observations", "--total_environment_frames=256"],
    "r2d2-nstep-eval-envs": [
        "--agent=r2d2", "--env=discrete_match", "--num_envs=16",
        "--num_eval_envs=6", "--unroll_length=4", "--burn_in=1",
        "--n_steps=2", "--replay_buffer_size=64",
        "--replay_buffer_min_size=16", "--batch_size=8",
        "--total_environment_frames=320"],
    "r2d2-retrace": [
        "--agent=r2d2", "--env=discrete_match", "--num_envs=16",
        "--num_eval_envs=2", "--unroll_length=4", "--burn_in=1",
        "--target=retrace", "--replay_buffer_size=64",
        "--replay_buffer_min_size=16", "--batch_size=8",
        "--total_environment_frames=256"],
    "ppo-split-gae": [
        "--agent=ppo", "--env=toy", "--num_envs=16", "--unroll_length=4",
        "--epochs_per_step=2", "--batches_per_step=4",
        "--total_environment_frames=256"],
    "ppo-vmpo-popart-lstm": [
        "--agent=ppo", "--env=discrete_match", "--num_envs=16",
        "--unroll_length=4", "--epochs_per_step=2", "--batches_per_step=4",
        "--policy_loss=vmpo", "--total_environment_frames=256"],
    "ppo-awr-vtrace-repeat": [
        "--agent=ppo", "--env=toy_memory", "--num_envs=16",
        "--unroll_length=4", "--epochs_per_step=2", "--batches_per_step=2",
        "--batch_mode=repeat", "--advantage_estimator=vtrace",
        "--policy_loss=awr", "--total_environment_frames=256"],
    "sac-continuous": [
        "--agent=sac", "--env=toy", "--num_envs=16", "--unroll_length=2",
        "--batch_size=16", "--replay_buffer_size=64",
        "--replay_buffer_min_size=32", "--target_entropy=auto",
        "--total_environment_frames=256"],
    "sac-normalized": [
        "--agent=sac", "--env=toy", "--num_envs=16", "--unroll_length=2",
        "--batch_size=16", "--replay_buffer_size=64",
        "--replay_buffer_min_size=32", "--normalize_observations",
        "--total_environment_frames=192"],
    # From Catch frames, each within TOL (rtol 1e-4 / atol 1e-5): R2D2
    # (DuelingLSTMDQNNet, the device replay of frames sharded by slot) and
    # PPO (AtariPolicyNet, shuffle minibatches of frame columns).
    "r2d2-catch": [
        "--agent=r2d2", "--env=catch", "--num_envs=16", "--unroll_length=4",
        "--burn_in=1", "--n_steps=2", "--replay_buffer_size=64",
        "--replay_buffer_min_size=16", "--batch_size=8",
        "--total_environment_frames=128"],
    "ppo-catch": [
        "--agent=ppo", "--env=catch", "--num_envs=16", "--unroll_length=4",
        "--epochs_per_step=1", "--batches_per_step=2",
        "--total_environment_frames=128"],
    "sac-discrete-her": [
        "--agent=sac", "--env=bit_flipping", "--her_window_length=4",
        "--unroll_length=2", "--num_envs=16", "--batch_size=16",
        "--replay_buffer_size=64", "--replay_buffer_min_size=32",
        "--total_environment_frames=256"],
}
REPLICATED = ("params", "opt", "target", "priorities", "generators",
              "obs_norm", "norm_state")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Rank 0 runs in this process: one intra-op thread, as the spawned
    ranks have, so that the test workers sharing the cores do not stall
    each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- JAX's side of the direct checks -----------------------------------------

VTRACE_B, VTRACE_T = 8, 6


def _vtrace_jax_case():
    """A JAX V-trace update on a mid-stream unroll (MLPAndLSTM, tanh-normal
    actions, the clip active) and what the ranks need to redo it."""
    config = dict(lambda_=0.9, kl_cost=0.5, target_entropy=-2.0,
                  discounting=0.9)
    jnet = JaxMLPAndLSTM(6, mlp_sizes=(16,), lstm_sizes=(8,))
    jagent = JaxPolicyAgent(jnet, jpd.NormalTanhDistribution(3))
    jengine = JaxRolloutEngine(
        JaxBatchedEnv(JaxToyEnv(horizon=3), VTRACE_B), jagent, VTRACE_T)
    jlearner = jax_vtrace.VTraceLearner(
        jengine, jagent, jax_vtrace.VTraceConfig(**config),
        optax.chain(optax.clip_by_global_norm(0.05), optax.adam(1e-3)))
    jstate = jlearner.init(jax.random.PRNGKey(0))
    rollout = jax.jit(jengine.rollout)
    _, unroll = rollout(jstate.params["net"],
                        rollout(jstate.params["net"], jstate.rollout)[0])
    loss_rng = jax.random.PRNGKey(7)
    jnew, jmetrics = jax.jit(jlearner.update)(jstate, unroll, loss_rng)
    noise = np.asarray(jax.random.normal(loss_rng, (VTRACE_T, VTRACE_B, 3),
                                         jnp.float32))
    tnet = MLPAndLSTM(6, 4, mlp_sizes=(16,), lstm_sizes=(8,), device="cpu")
    state_dict, entropy_cost = convert.vtrace_params(
        tnet, _np_tree(jstate.params))
    want, want_ec = convert.vtrace_params(tnet, _np_tree(jnew.params))
    ts = unroll.timesteps
    spec = dict(
        state_dict={k: v.numpy() for k, v in state_dict.items()},
        entropy_cost=float(entropy_cost), num_envs=VTRACE_B,
        unroll_length=VTRACE_T, config=config, lr=1e-3, clip_norm=0.05,
        noise=noise,
        unroll=(_np_tree(unroll.agent_state), np.asarray(ts.prev_action),
                tuple(map(np.asarray, ts.env_output)),
                tuple(map(np.asarray, ts.agent_output)), False))
    return spec, dict(
        params={k: v.numpy() for k, v in want.items()},
        entropy_cost=float(want_ec),
        metrics={k: float(v) for k, v in jmetrics.items()},
        stats=[np.asarray(x) for x in jnew.stats])


R2D2_NET = dict(mlp_sizes=(16,), lstm_size=8, hidden_size=16)


def _r2d2_jax_case(target):
    """A JAX R2D2 batch (8 envs, 2 of them eval envs, a 32-unroll replay
    after two warm-up steps, a target net that differs from the online
    one) and what the ranks need to redo it at JAX's indices."""
    num_envs, num_eval, burn_in = 8, 2, 2 if target == "nstep" else 0
    env = JaxBatchedEnv(jax_toy.DiscreteMatchEnv(n_actions=4, horizon=10),
                        num_envs)
    net = JaxVectorDuelingDQNNet(num_actions=4, **R2D2_NET)
    agent = jax_r2d2.R2D2Agent(net, jnp.concatenate([
        jax_r2d2.training_env_epsilons(num_envs - num_eval),
        jnp.full((num_eval,), 1e-3)]))
    engine = JaxRolloutEngine(env, agent, 6, num_overlapping_steps=burn_in)
    config = jax_r2d2.R2D2Config(
        discounting=0.9, n_steps=3, burn_in=burn_in, replay_buffer_size=32,
        replay_buffer_min_size=12, batch_size=8,
        update_target_every_n_step=2, num_eval_envs=num_eval,
        target=target)
    clip = 0.05 if target == "nstep" else 40.0
    jlearner = jax_r2d2.R2D2Learner(
        engine, agent, config,
        optax.chain(optax.clip_by_global_norm(clip), optax.adam(1e-3)))
    jstate = jax.jit(jlearner.init)(jax.random.PRNGKey(0))
    for _ in range(2):
        jstate = jax.jit(jlearner.warmup_step)(jstate)
    target_params = jlearner.agent.init_params(
        jax.random.PRNGKey(9), jnp.zeros((8,), jnp.int32),
        jlearner.engine.env.reset(jax.random.PRNGKey(1))[1])
    carry = (jstate.params, target_params, jstate.opt_state, jstate.replay,
             jax.random.PRNGKey(4))
    _, sample_rng = jax.random.split(carry[-1])
    jidx, _, _ = jlearner.replay.sample(
        jstate.replay, sample_rng, config.batch_size,
        config.priority_exponent)
    (params, _, _, jreplay, _), jlogs = jax.jit(jlearner._train_on_batch)(
        carry, None)

    tnet = VectorDuelingDQNNet(4, 4, device="cpu", **R2D2_NET)

    def named(tree):
        return {k: v.numpy() for k, v in convert.state_dict_for(
            tnet, _np_tree(tree)).items()}

    items = jlearner.replay._unflatten_batch(jstate.replay.buffer)
    spec = dict(
        num_envs=num_envs, unroll_length=6, lr=1e-3, clip_norm=clip,
        net=R2D2_NET, params=named(jstate.params),
        target_params=named(target_params),
        config={f: getattr(config, f)
                for f in r2d2.R2D2Config.__dataclass_fields__},
        buffer=(_np_tree(items.agent_state), np.asarray(items.prev_actions),
                tuple(map(np.asarray, items.env_outputs)),
                tuple(map(np.asarray, items.agent_outputs))),
        priorities=np.asarray(jstate.replay.priorities),
        insert_index=int(jstate.replay.insert_index),
        num_inserted=int(jstate.replay.num_inserted),
        indices=np.asarray(jidx))
    return spec, dict(params=named(params),
                      logs={k: float(v) for k, v in jlogs.items()},
                      priorities=np.asarray(jreplay.priorities))


# Synthetic Football frames' dtype across the ranks (C6): 8 items of 3x5
# uint16 frames, the top bit set in some, a 16-slot replay sharded by slot,
# a sample that takes items from both ranks' slots.
_RNG = np.random.RandomState(0)
UINT16_SPEC = dict(
    frames=_RNG.randint(0, 2 ** 16, (8, 3, 5)).astype(np.uint16).view(
        np.int16),
    size=16, indices=np.array([9, 0, 3, 8, 12, 1, 9], np.int64))


# -- one process group for every two-rank job --------------------------------


@pytest.fixture(scope="module")
def runs():
    """Each case run on one rank here and on two ranks (one spawn for all
    of them); returns {case: (one-rank result, [rank 0's, rank 1's])}."""
    torch.set_num_threads(1)
    todo, refs, names = [], {}, []
    for name, argv in CLI_CASES.items():
        names.append(name)
        refs[name] = workers.cli(None, argv + COMMON + ["--num_replicas=1"])
        todo.append(("cli", argv + COMMON + ["--num_replicas=2"]))
    spec, refs["jax-vtrace"] = _vtrace_jax_case()
    names.append("jax-vtrace")
    todo.append(("vtrace_update", spec))
    for target in ("nstep", "retrace"):
        spec, refs[f"jax-r2d2-{target}"] = _r2d2_jax_case(target)
        names.append(f"jax-r2d2-{target}")
        todo.append(("r2d2_batch", spec))
    names.append("gathers")
    refs["gathers"] = None
    todo.append(("gathers", None))
    names.append("uint16_frames")
    refs["uint16_frames"] = UINT16_SPEC
    todo.append(("uint16_frames", UINT16_SPEC))
    ranks = parallel.spawn(workers.jobs, 2, "cpu", args=(todo,), threads=1,
                           timeout_secs=300)
    return {name: (refs[name], [ranks[0][i], ranks[1][i]])
            for i, name in enumerate(names)}


def _close(got, want, what, tol=TOL):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), **tol,
                                   err_msg=f"{what}[{i}]")


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_two_ranks_match_one_rank(runs, case):
    one, (r0, _) = runs[case]
    assert r0["step"] == one["step"] > 0
    for key in REPLICATED:
        if key in one:
            _close(r0[key], one[key], key)
    assert set(r0["metrics"]) == set(one["metrics"])
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(r0["metrics"][k], v, **TOL, err_msg=k)
    _close(r0["window"], one["window"], "episode window")
    for key in ("eval_window",):
        if key in one:
            _close(r0[key], one[key], key)
    assert r0.get("num_inserted") == one.get("num_inserted")


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_replicated_state_is_bitwise_equal_across_ranks(runs, case):
    _, (r0, r1) = runs[case]
    for key in REPLICATED:
        if key not in r0:
            continue
        for a, b in zip(jax.tree.leaves(r0[key]), jax.tree.leaves(r1[key])):
            assert np.array_equal(np.asarray(a), np.asarray(b)), key
    assert r0["metrics"] == r1["metrics"]
    assert r0["window"] == r1["window"]


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_each_rank_holds_its_share(runs, case):
    one, ranks = runs[case]
    assert one["num_envs"] == 16
    assert [r["num_envs"] for r in ranks] == [8, 8]
    if "slots" in one:
        assert [r["slots"] for r in ranks] == [one["slots"] // 2] * 2
    # The ranks' accumulators are the one-rank run's, in env order.
    np.testing.assert_allclose(
        np.concatenate([r["return_acc"] for r in ranks]), one["return_acc"],
        **TOL)
    if "eval_return_acc" in one:
        np.testing.assert_allclose(
            np.concatenate([r["eval_return_acc"] for r in ranks]),
            one["eval_return_acc"], **TOL)


def test_r2d2_eval_envs_split_by_global_id(runs):
    """16 envs, 6 of them eval envs (ids 10-15): rank 0 holds 8 training
    envs, rank 1 holds 2 training and 6 eval envs."""
    _, ranks = runs["r2d2-nstep-eval-envs"]
    assert [r["return_acc"].shape[0] for r in ranks] == [8, 2]
    assert [r["eval_return_acc"].shape[0] for r in ranks] == [0, 6]


def test_vtrace_two_ranks_match_jax_update(runs):
    want, ranks = runs["jax-vtrace"]
    for got in ranks:
        _close(got["params"], want["params"], "params")
        np.testing.assert_allclose(got["entropy_cost"], want["entropy_cost"],
                                   **TOL)
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, **TOL,
                                       err_msg=k)
    # Episode statistics: the ranks' accumulators in env order, and the
    # window's sums added over the ranks.
    return_acc, *window = want["stats"]
    np.testing.assert_allclose(
        np.concatenate([r["return_acc"] for r in ranks]), return_acc, **TOL)
    _close(ranks[0]["window"], window, "window")


@pytest.mark.parametrize("target", ["nstep", "retrace"])
def test_r2d2_two_ranks_match_jax_batch(runs, target):
    want, ranks = runs[f"jax-r2d2-{target}"]
    assert [r["slots"] for r in ranks] == [16, 16]
    for got in ranks:
        _close(got["params"], want["params"], "params")
        assert set(got["logs"]) == set(want["logs"])
        for k, v in want["logs"].items():
            np.testing.assert_allclose(got["logs"][k], v, **TOL, err_msg=k)
        np.testing.assert_allclose(got["priorities"], want["priorities"],
                                   **TOL)
    assert np.array_equal(ranks[0]["priorities"], ranks[1]["priorities"])


# -- without a process group --------------------------------------------------


def test_sharded_draws_are_slices_of_the_global_draw():
    g = torch.Generator().manual_seed(3)
    full = torch.rand((4, 10, 3), generator=g)
    for keep in (slice(5, 10), torch.tensor([1, 4, 8])):
        g.manual_seed(3)
        part = draws.rand((4, 5 if isinstance(keep, slice) else 3, 3),
                          draws.ShardedGenerator(g, 10, keep, axis=1))
        assert torch.equal(part, full[:, keep])
    with pytest.raises(ValueError, match="keeps 5 of 10"):
        draws.randn((4, 3), draws.ShardedGenerator(g, 10, slice(0, 5)))


def test_a_sharded_env_steps_as_its_slice_of_the_whole():
    """A rank's envs (``BatchedEnv(mesh=...)``, no process group needed)
    reset and step exactly as its columns of the one-rank batch."""
    whole = BatchedEnv(ToyEnv(horizon=3), 8, device="cpu", seed=5)
    halves = [BatchedEnv(ToyEnv(horizon=3), 8, device="cpu", seed=5,
                         mesh=parallel.Mesh(r, 2, "cpu")) for r in (0, 1)]
    state, out = whole.reset()
    parts = [h.reset() for h in halves]
    action = torch.rand((8, 3)) * 2 - 1
    for _ in range(4):
        state, out = whole.step(state, action)
        parts = [h.step(s, action[h.env_ids])
                 for h, (s, _) in zip(halves, parts)]
        for h, (_, o) in zip(halves, parts):
            for a, b in zip(o, out):
                assert torch.equal(a, b[h.env_ids])


def test_priority_write_back_keeps_the_last_duplicate():
    """Replicated priorities are written alike on every rank: where an
    index repeats in a batch, its last value wins (a scatter on the card
    picks among duplicates in no fixed order)."""
    from seed_rl_torch.replay import PrioritizedReplay, ReplayState

    replay = PrioritizedReplay(6, 0.6)
    state = ReplayState(buffer=torch.zeros(6), priorities=torch.zeros(6),
                        insert_index=0, num_inserted=6)
    state = replay.update_priorities(
        state, torch.tensor([4, 1, 4, 0, 1, 4]),
        torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]))
    assert state.priorities.tolist() == [4.0, 5.0, 0.0, 0.0, 6.0, 0.0]


def test_gather_to_host_holds_every_part_on_rank_0_only(runs):
    """Uneven parts (3 rows on rank 0, 1 on rank 1), along either axis and
    of bools, land whole on rank 0's CPU; rank 1 keeps only their global
    shape, on the meta device. A
    checkpoint's per-env leaves are the global ones on rank 0 and meta
    tensors of the global shape on rank 1, as the layout is on both."""
    _, (r0, r1) = runs["gathers"]
    want = np.array([[0, 1], [2, 3], [4, 5], [10, 11]], np.float32)
    x, x_t, flags = r0["gathered"]
    np.testing.assert_array_equal(x, want)
    np.testing.assert_array_equal(x_t, want.T)
    np.testing.assert_array_equal(flags, [True, False, True, False])
    assert r1["gathered"] == [("meta", (4, 2)), ("meta", (2, 4)),
                              ("meta", (4,))]
    assert {d for d, _ in r0["rollout"]} == {"cpu"}
    assert {d for d, _ in r1["rollout"]} == {"meta"}
    assert ({s for _, s in r0["rollout"]} == {s for _, s in r1["rollout"]}
            == {s for _, s in r0["layout"]})
    assert {d for d, _ in r0["layout"] + r1["layout"]} == {"meta"}
    assert any(s and s[0] == 4 for _, s in r0["rollout"])


def test_uint16_frames_cross_the_ranks_bit_for_bit(runs):
    """C6 over gloo: uint16 frames cross the collectives as their int16
    view and come back uint16, bit for bit: the all-gather and the gather
    to rank 0's host in rank order, and the replay sharded by slot samples
    the inserted frames from both ranks' slots (two inserts of both ranks'
    halves in rank order fill the 16 slots: slot s holds item s % 8)."""
    spec, ranks = runs["uint16_frames"]
    frames = spec["frames"]
    ring = frames
    for r in ranks:
        assert r["dtypes"] == ["torch.uint16", "torch.uint16"]
        np.testing.assert_array_equal(r["gathered"], frames)
        np.testing.assert_array_equal(r["sampled"],
                                      ring[spec["indices"] % 8])
    np.testing.assert_array_equal(ranks[0]["hosted"], frames)
    assert ranks[1]["hosted"] == "meta"


def test_main_runs_on_the_device_the_argv_asks_for(monkeypatch):
    """A rank of a gloo group whose mesh holds the CPU does not train an
    argv that asks for the card, by default or by name; ``make_mesh``
    defaults to the card where CUDA is up, whatever the backend."""
    import torch.distributed as dist
    from seed_rl_torch import train

    argv = ["--agent=vtrace", "--env=toy", "--num_envs=4",
            "--unroll_length=2", "--total_environment_frames=8",
            "--steps_per_call=1"]
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{parallel.mesh.free_port()}",
        world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh(devices=["cpu"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        for device in ([], ["--device=cuda"]):
            with pytest.raises(ValueError, match="runs on cpu"):
                train.main(argv + device, mesh=mesh)
        assert parallel.make_mesh().device == torch.device("cuda", 0)
        monkeypatch.undo()
        _, state, _ = train.main(argv + ["--device=cpu"], mesh=mesh)
        assert state.step == 1
    finally:
        dist.destroy_process_group()


def test_collectives_are_torch_outside_a_mesh():
    x = torch.randn(5, 4)
    assert collectives.active() is None
    assert torch.equal(collectives.mean(x, dim=0), torch.mean(x, dim=0))
    assert torch.equal(collectives.std(x), torch.std(x, correction=0))
    assert collectives.count(x) == 20
    with collectives.over(parallel.Mesh(0, 1, "cpu")):
        assert collectives.active() is None  # one rank: nothing to reduce


def test_mesh_refusals():
    with pytest.raises(NotImplementedError, match="model"):
        parallel.make_mesh(model_parallelism=2)
    with pytest.raises(ValueError, match="process group"):
        parallel.make_mesh(num_replicas=2)
    with pytest.raises(ValueError, match="does not divide"):
        BatchedEnv(ToyEnv(), 9, device="cpu", mesh=parallel.Mesh(0, 2, "cpu"))
    mesh = parallel.make_mesh()
    assert (mesh.rank, mesh.size, mesh.collective) == (0, 1, False)


def test_distributed_learner_needs_the_meshs_envs():
    from seed_rl_torch import optim
    from seed_rl_torch.agent import PolicyAgent
    from seed_rl_torch.agents import vtrace
    from seed_rl_torch import distributions as tpd
    from seed_rl_torch.rollout import RolloutEngine

    net = MLPAndLSTM(6, 4, mlp_sizes=(8,), lstm_sizes=(4,), device="cpu")
    agent = PolicyAgent(net, tpd.NormalTanhDistribution(3))
    learner = vtrace.VTraceLearner(
        RolloutEngine(BatchedEnv(ToyEnv(), 4, device="cpu"), agent, 3),
        agent, vtrace.VTraceConfig(),
        functools.partial(optim.ClippedAdam, learning_rate=1e-3))
    with pytest.raises(ValueError, match="mesh's share"):
        parallel.DistributedLearner(learner, parallel.Mesh(0, 2, "cpu"))
    one = parallel.DistributedLearner(learner, parallel.make_mesh())
    state, _ = one.train_step(one.init())
    assert state.step == 1
