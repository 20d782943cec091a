"""GTrXL on IMPALA's torso (``seed_rl_torch/models/gtrxl.py``) against a
plain float64 reference (``tests/gtrxl_reference.py``), at a small size:
2 layers of width 16, 2 heads of 8, memory 8, unroll 5, 3 envs whose
episodes end every 11 steps, over 7 unrolls (36 steps: the ring of 9 rows
wraps four times and every env restarts three times); the same checks
again with envs whose episodes end every 7, 13 and 11 steps, so each env's
episode starts at steps of its own.

The port computes in float32 here. Tolerances: ``ATOL`` (1e-5) and
``RTOL`` (1e-5) between the port and the float64 reference are ten times
float32's rounding through the few hundred operations of these widths
(the largest gap read is ~1e-6); acting against learning in the port is
held to the same (two float32 orders of the same sums); a gradient to
``GRAD_RTOL`` (1e-4) of its leaf's largest element, as the backward of the
softmax and LayerNorm sums more terms.

Also: the window and the episode mask (a frame ``memory_length + 1`` steps
back, or in the episode before, changes nothing; ``memory_length`` back
does), the counters, the graph path's stand-in with the state kept in its
static inputs, and the CLI's ``--core=gtrxl``. This file imports no JAX.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import graph_fakes as fakes
import gtrxl_reference as ref
from seed_rl_torch import distributions as pd
from seed_rl_torch import train
from seed_rl_torch.agent import PolicyAgent
from seed_rl_torch.agents import vtrace
from seed_rl_torch.envs import BatchedEnv, dmlab
from seed_rl_torch.envs.synthetic import (
    SyntheticAtariGymEnv,
    SyntheticDmLabEnv,
)
from seed_rl_torch.models import ImpalaDeep, ImpalaGTrXL
from seed_rl_torch.rollout import RolloutEngine
from seed_rl_torch.types import EnvOutput
from seed_rl_torch.utils import profiling

CPU = torch.device("cpu")
SIZES = dict(num_layers=2, model_size=16, num_heads=2, head_size=8,
             memory_length=8, mlp_size=32)
FRAME = (12, 16)
ACTIONS = 9
ENVS, UNROLL, EPISODE, ROLLOUTS = 3, 5, 11, 7
# Per-env episode lengths of ``_StaggeredDmLab``: over 36 steps env 0
# restarts at 7, 14, 21, 28, 35, env 1 at 13, 26, env 2 at 11, 22, 33.
STAGGERED = (7, 13, 11)
ATOL = RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _net(seed=0, **sizes):
    net = ImpalaGTrXL(ACTIONS, FRAME + (3,), **dict(SIZES, **sizes),
                      seed=seed, device=CPU)
    # Gates away from their identity start, so every path carries signal.
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("gate1.bias") or name.endswith("gate2.bias"):
                p.fill_(0.5)
            if "content_bias" in name or "position_bias" in name:
                p.normal_(0.0, 0.5, generator=torch.Generator().manual_seed(
                    len(name)))
    return net


class _StaggeredDmLab(SyntheticDmLabEnv):
    """``SyntheticDmLabEnv`` whose env i ends its episodes every
    ``STAGGERED[i]`` steps, so the envs restart at different steps."""

    def step(self, state, action, generator):
        result = super().step(state, action, generator)
        lengths = torch.tensor(STAGGERED, dtype=state.t.dtype)
        return result._replace(terminated=result.state.t >= lengths)


def _engine(net, seed=3, env_class=SyntheticDmLabEnv):
    env = BatchedEnv(env_class(frame_shape=FRAME, episode_length=EPISODE),
                     ENVS, device=CPU, seed=seed)
    agent = PolicyAgent(net, pd.CategoricalDistribution(ACTIONS))
    return RolloutEngine(env, agent, UNROLL, seed=seed + 1)


def _trajectory(engine, n=ROLLOUTS):
    state, unrolls = engine.init(), []
    for _ in range(n):
        state, unroll = engine.rollout(state)
        unrolls.append(unroll)
    return unrolls, state


def _history(unrolls, upto=None):
    """The [N, B] history of the first ``upto`` unrolls (all by default)."""
    return ref.history([{
        "frames": u.timesteps.env_output.observation,
        "reward": u.timesteps.env_output.reward,
        "prev_action": u.timesteps.prev_action,
        "done": u.timesteps.env_output.done,
        "logits": u.timesteps.agent_output.policy_logits,
        "baseline": u.timesteps.agent_output.baseline,
        "action": u.timesteps.agent_output.action,
    } for u in unrolls[:upto]])


def _reference(params, h, grad_from=0):
    return ref.forward(params, h["frames"], h["reward"], h["prev_action"],
                       h["done"], ACTIONS, SIZES["num_heads"],
                       SIZES["memory_length"], grad_from)


def _close(got, want, atol=ATOL, rtol=RTOL):
    torch.testing.assert_close(got.to(torch.float64), want.detach(),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def trajectory():
    net = _net()
    engine = _engine(net)
    unrolls, state = _trajectory(engine)
    return net, engine, unrolls, state


@pytest.fixture(scope="module")
def staggered():
    net = _net()
    engine = _engine(net, env_class=_StaggeredDmLab)
    unrolls, state = _trajectory(engine)
    return net, engine, unrolls, state


def _acts_as_the_reference(net, engine, unrolls):
    h = _history(unrolls)
    logits, baseline, _ = _reference(ref.params_of(net), h)
    _close(h["logits"], logits)
    _close(h["baseline"], baseline)


def test_the_rollout_acts_as_the_reference(trajectory):
    net, engine, unrolls, _ = trajectory
    h = _history(unrolls)
    assert h["done"].sum() == ENVS * 3  # restarts at steps 11, 22 and 33
    _acts_as_the_reference(net, engine, unrolls)


def test_unroll_from_the_stored_state_is_the_reference(trajectory):
    _unroll_is_the_reference(*trajectory[:3])


def _unroll_is_the_reference(net, engine, unrolls):
    logits, baseline, _ = _reference(ref.params_of(net), _history(unrolls))
    for k, u in enumerate(unrolls):
        ts = u.timesteps
        (got_logits, got_baseline), _ = engine.agent.unroll(
            ts.prev_action, ts.env_output, u.agent_state)
        steps = slice(k * UNROLL, k * UNROLL + UNROLL + 1)
        _close(got_logits, logits[steps])
        _close(got_baseline, baseline[steps])


def test_the_stored_memory_is_the_reference_s_layer_inputs(trajectory):
    _memory_is_the_reference(*trajectory[:3])


def _memory_is_the_reference(net, engine, unrolls):
    # Unroll k stores the ring as it stood before step k * T: the rows of
    # steps k*T - 9 .. k*T - 1, at slot step % 9, those of the env's own
    # episode within the window compared.
    _, _, inputs = _reference(ref.params_of(net), _history(unrolls))
    ring = SIZES["memory_length"] + 1
    for k, u in enumerate(unrolls):
        state = u.agent_state
        t0 = k * UNROLL
        assert (state.time == t0).all()
        for layer, memory in enumerate(state.memory):
            for step in range(max(t0 - SIZES["memory_length"], 0), t0):
                keep = state.episode_start <= step
                _close(memory[keep, step % ring],
                       inputs[layer][step][keep])
        assert ring == memory.shape[1]


def test_acting_and_learning_are_one_function(trajectory):
    _learning_is_acting(*trajectory[:3])


def _learning_is_acting(net, engine, unrolls):
    for u in unrolls:
        ts = u.timesteps
        (logits, baseline), _ = engine.agent.unroll(
            ts.prev_action, ts.env_output, u.agent_state)
        torch.testing.assert_close(logits, ts.agent_output.policy_logits,
                                   atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(baseline, ts.agent_output.baseline,
                                   atol=ATOL, rtol=RTOL)


def test_unroll_returns_the_state_acting_reaches(trajectory):
    _, engine, unrolls, _ = trajectory
    for u, after in zip(unrolls[:-1], unrolls[1:]):
        ts = u.timesteps
        # The state before the unroll's last step, where the next starts.
        _, state = engine.agent.unroll(
            pytree.tree_map(lambda x: x[:-1], ts.prev_action),
            pytree.tree_map(lambda x: x[:-1], ts.env_output), u.agent_state)
        want = after.agent_state
        assert torch.equal(state.time, want.time)
        assert torch.equal(state.episode_start, want.episode_start)
        for got, kept in zip(state.memory, want.memory):
            torch.testing.assert_close(got, kept, atol=ATOL, rtol=RTOL)


def test_the_vtrace_gradient_is_the_reference_s(trajectory):
    net, engine, unrolls, _ = trajectory
    config = vtrace.VTraceConfig(discounting=0.99, entropy_cost=0.01)
    speed = config.entropy_cost_adjustment_speed
    entropy_cost = torch.tensor(np.log(config.entropy_cost) / speed)
    k = len(unrolls) - 1  # after the ring wrapped and envs restarted
    net.zero_grad()
    loss, _ = vtrace.compute_loss(config, engine.agent,
                                  engine.agent.distribution, entropy_cost,
                                  unrolls[k])
    loss.backward()
    params = ref.params_of(net)
    h = _history(unrolls)
    logits, baseline, _ = _reference(params, h, grad_from=k * UNROLL)
    steps = slice(k * UNROLL, k * UNROLL + UNROLL + 1)
    want = ref.vtrace_loss(logits[steps], baseline[steps], h["logits"][steps],
                           h["action"][steps], h["reward"][steps],
                           h["done"][steps], config.discounting,
                           config.baseline_cost, config.entropy_cost)
    want.backward()
    _close(loss, want)
    for name, p in net.named_parameters():
        scale = float(params[name].grad.abs().max())
        assert scale > 0, name
        _close(p.grad, params[name].grad, atol=GRAD_RTOL * scale, rtol=0)


def _acting_output(net, frames, done):
    """The last step's logits of ``net`` acting from its initial state
    through ``frames`` [N, H, W, 3] (one env) with ``done`` [N]."""
    state = net.initial_state(1)
    with torch.no_grad():
        for t in range(frames.shape[0]):
            env_output = EnvOutput(
                reward=torch.zeros(1), done=done[t:t + 1],
                observation=frames[t:t + 1], abandoned=torch.zeros(
                    1, dtype=torch.bool),
                episode_step=torch.zeros(1, dtype=torch.int32))
            (logits, _), state = net(torch.zeros(1, dtype=torch.int32),
                                     env_output, state)
    return logits


def _frames(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n,) + FRAME + (3,), generator=g,
                         dtype=torch.uint8)


@pytest.mark.parametrize("back,changes", [(9, False), (8, True)],
                         ids=["memory_length+1", "memory_length"])
def test_a_frame_beyond_the_window_changes_nothing(back, changes):
    # One layer: a frame reaches a later step through that layer's keys
    # alone (deeper layers widen the field by a window a layer).
    net = _net(num_layers=1)
    frames, done = _frames(15), torch.zeros(15, dtype=torch.bool)
    want = _acting_output(net, frames, done)
    frames[14 - back] = 255 - frames[14 - back]
    got = _acting_output(net, frames, done)
    assert torch.equal(got, want) != changes


@pytest.mark.parametrize("step,changes", [(9, False), (10, True)],
                         ids=["the_episode_before", "its_first_step"])
def test_the_episode_before_changes_nothing(step, changes):
    net = _net()
    frames, done = _frames(15), torch.zeros(15, dtype=torch.bool)
    done[10] = True  # step 10 starts the episode step 14 is in
    want = _acting_output(net, frames, done)
    frames[step] = 255 - frames[step]
    got = _acting_output(net, frames, done)
    assert torch.equal(got, want) != changes


def test_the_counters(trajectory):
    _counters_are_the_reference_s(*trajectory[:3])


def _counters_are_the_reference_s(net, engine, unrolls):
    done = _history(unrolls)["done"]
    steps = done.shape[0]
    start = ref.starts(done)
    t = torch.arange(steps)[:, None]
    keys = (torch.minimum(t - start, torch.tensor(SIZES["memory_length"]))
            + 1).sum()
    # The engine's first step, then the rollouts' T steps each.
    assert steps == 1 + ROLLOUTS * UNROLL
    assert int(net.counters["queries"]) == ENVS * steps
    assert int(net.counters["keys"]) == int(keys)
    assert int(net.counters["restarts"]) == int(done.sum())


STAGGERED_CHECKS = {
    "acting": _acts_as_the_reference,
    "unroll": _unroll_is_the_reference,
    "memory": _memory_is_the_reference,
    "learning_is_acting": _learning_is_acting,
    "counters": _counters_are_the_reference_s,
}


@pytest.mark.parametrize("check", sorted(STAGGERED_CHECKS))
def test_envs_that_restart_apart(staggered, check):
    # Each env's episode start is its own: envs restart at different steps
    # (and one in the middle of another's window), held to the reference,
    # whose episode mask is per env.
    net, engine, unrolls, _ = staggered
    done = _history(unrolls)["done"]
    assert done.sum(0).tolist() == [5, 2, 3]
    assert not (done.any(1) == done.all(1)).all()
    STAGGERED_CHECKS[check](net, engine, unrolls)


class _Capture(fakes.DirectCall):
    """``DirectCall``, whose capture also puts the net's counters back: a
    graph's capture counts nothing."""

    def __init__(self, generators, device, counters):
        super().__init__(generators, device)
        self.counters = counters

    def capture(self, fn):
        before = {n: c.clone() for n, c in self.counters.items()}
        out = super().capture(fn)
        for name, counter in self.counters.items():
            counter.copy_(before[name])
        return out


def test_the_graph_path_keeps_the_state_in_its_inputs():
    eager_net, graphed_net = _net(), _net()
    eager, graphed = _engine(eager_net), _engine(graphed_net)
    fakes.graphed(graphed, _Capture, counters=graphed_net.counters)
    want, want_state = _trajectory(eager, 4)
    got, got_state = _trajectory(graphed, 4)
    assert graphed.captures == 1 and graphed.graph_replays == 3
    for g, w in zip(got + [got_state], want + [want_state]):
        for x, y in zip(pytree.tree_leaves(g), pytree.tree_leaves(w)):
            assert torch.equal(x, y)
    for name, counter in graphed_net.counters.items():
        assert torch.equal(counter, eager_net.counters[name]), name
    # The ring is the graph's static input, handed out and passed back
    # uncopied; each unroll keeps a memory of its own.
    static = graphed._graph.inputs.agent_state.memory
    assert all(a is b for a, b in zip(got_state.agent_state.memory, static))
    pointers = {u.agent_state.memory[0].data_ptr() for u in got}
    assert len(pointers) == 4 and static[0].data_ptr() not in pointers


def _cli(*flags):
    return ["--device=cpu", "--agent=vtrace", "--core=gtrxl",
            "--num_envs=2", "--unroll_length=3", "--steps_per_call=1",
            "--log_every_steps=1", "--total_environment_frames=12",
            *flags]


def test_the_cli_trains_gtrxl_on_device_frames():
    proc = subprocess.run(
        [sys.executable, "-m", "seed_rl_torch.train",
         *_cli("--env=synthetic_atari", "--conv_net=impala_deep")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # The console logs at most one line in 30 s: the first step's.
    assert "step=1 " in proc.stdout and "nan" not in proc.stdout


class _DmLabShapedFrames(SyntheticAtariGymEnv):
    """A host env of DMLab-shaped frames (72x96 RGB uint8, 9 actions),
    standing in for ``deepmind_lab``."""

    def __init__(self):
        from gymnasium.spaces import Box

        super().__init__(num_actions=9, frame_shape=(72, 96))
        self.observation_space = Box(0, 255, (72, 96, 3), np.uint8)

    def _obs(self):
        return np.repeat(super()._obs(), 3, axis=-1)


def test_the_cli_trains_gtrxl_on_dmlab_frames(monkeypatch):
    monkeypatch.setattr(dmlab, "create_environment",
                        lambda game, task=0: _DmLabShapedFrames())
    learner, state, metrics = train.main(_cli("--env=dmlab"))
    assert state.step == 2
    net = learner.agent.net
    assert isinstance(net, ImpalaGTrXL)
    assert (len(net.layers), net.model_size, net.memory_length) == (12, 256,
                                                                    512)
    assert int(net.counters["queries"]) == 0  # the host engine's copy acts
    assert int(learner.engine.behaviour.agent.net.counters["queries"]) > 0
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_lstm_stays_the_default(monkeypatch):
    monkeypatch.setattr(dmlab, "create_environment",
                        lambda game, task=0: _DmLabShapedFrames())
    learner, _, _ = train.main([f for f in _cli("--env=dmlab")
                                if f != "--core=gtrxl"])
    assert type(learner.agent.net) is ImpalaDeep


@pytest.mark.parametrize("flags", [
    ("--env=catch",),  # AtariPolicyNet: no ImpalaDeep torso
    ("--env=toy",),
    ("--env=catch", "--conv_net=impala_deep", "--run_mode=learner"),
], ids=["atari_net", "vector_net", "remote"])
def test_gtrxl_without_impala_s_torso_is_refused(flags):
    with pytest.raises(ValueError, match="--core=gtrxl"):
        train.main(_cli(*flags))


def test_gtrxl_under_another_agent_is_refused():
    with pytest.raises(ValueError, match="--core=gtrxl"):
        train.main(["--device=cpu", "--agent=ppo", "--env=dmlab",
                    "--core=gtrxl"])


def test_profile_mode_records_the_core_s_spans(tmp_path, capsys):
    train.main(_cli("--env=synthetic_atari", "--conv_net=impala_deep",
                    f"--logdir={tmp_path}", "--run_mode=profile",
                    "--profile_calls=1"))
    capsys.readouterr()
    with open(tmp_path / "profile" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"seed_rl_torch.core", "seed_rl_torch.core.memory",
            "seed_rl_torch.rollout", "seed_rl_torch.update.loss"} <= names
    assert not profiling._recording


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_engine(device, memory_length, graphed):
    """The configuration's net at its widths (bf16 torso and core) over 8
    envs of 20-step episodes, unroll 8."""
    net = ImpalaGTrXL(ACTIONS, (72, 96, 3), memory_length=memory_length,
                      dtype=torch.bfloat16, core_dtype=torch.bfloat16,
                      seed=0, device=device)
    env = BatchedEnv(SyntheticDmLabEnv(episode_length=20), 8, device=device,
                     seed=3)
    engine = RolloutEngine(
        env, PolicyAgent(net, pd.CategoricalDistribution(ACTIONS)), 8,
        seed=4)
    if not graphed:
        engine._graph_class = None
    return net, engine


@pytest.mark.cuda
@pytest.mark.parametrize("memory_length", [512, 16])
def test_graphed_rollouts_are_the_eager_loop_s_on_the_card(cuda,
                                                           memory_length):
    # Memory 16 wraps its ring of 17 within the 33 steps; 512 is the
    # configuration's.
    eager_net, eager = _card_engine(cuda, memory_length, False)
    graphed_net, graphed = _card_engine(cuda, memory_length, True)
    want, want_state = _trajectory(eager, 4)
    got, got_state = _trajectory(graphed, 4)
    assert graphed.captures == 1 and graphed.capture_failures == 0
    assert graphed.graph_replays == 3
    for g, w in zip(got + [got_state], want + [want_state]):
        for x, y in zip(pytree.tree_leaves(g), pytree.tree_leaves(w)):
            assert torch.equal(x, y)
    for name, counter in graphed_net.counters.items():
        assert torch.equal(counter, eager_net.counters[name]), name
    static = graphed._graph.inputs.agent_state.memory
    assert all(a is b for a, b in zip(got_state.agent_state.memory, static))


@pytest.mark.cuda
def test_the_card_s_attention_is_the_memory_efficient_kernel(cuda):
    _, engine = _card_engine(cuda, 16, False)
    state = engine.init()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, unroll = engine.rollout(state)
        ts = unroll.timesteps
        (logits, _), _ = engine.agent.unroll(ts.prev_action, ts.env_output,
                                             unroll.agent_state)
        logits.sum().backward()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    assert any(n.startswith("fmha_cutlassF") for n in names), sorted(names)
    assert any(n.startswith("fmha_cutlassB") for n in names), sorted(names)
