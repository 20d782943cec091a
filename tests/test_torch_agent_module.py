"""``--agent_module`` (the free-composition hook) in seed_rl_torch against
the JAX package (mirroring tests/test_agent_module.py).

- The port's example, ``seed_rl_torch/examples/custom_ppo_composition.py``
  (V-MPO over V-trace advantages, PopArt compensation, a 3x128 tanh net
  behind EMA input normalization, a cosine-decayed AdamW), trains through
  the CLI, by path and by dotted name.
- A module that swaps only the optimizer is honoured under each agent, and
  its ``configure`` sees the keys the JAX CLI passes for that agent (read
  from ``seed_rl_tpu/train.py``'s source); a module without ``configure``
  fails loudly.
- One update of the example's composition against the JAX example's on the
  same parameters, unroll and draws (tests/test_torch_ppo.py's harness):
  logs and parameters within rtol 1e-3 / atol 1e-4, the PPO update
  tolerance.
- ``optim.ClippedAdam`` on a cosine schedule with a ``weight_decay``
  against ``optax.chain(clip_by_global_norm, adamw(cosine_decay_schedule))``
  over 3 steps within rtol 1e-5 / atol 1e-6, and its resume from a state
  dict bitwise; ``optim.linear_schedule`` against optax's.
"""

import ast
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seed_rl_tpu import distributions as jpd
from seed_rl_tpu.agents.ppo import learner as jlearner_mod
from seed_rl_tpu.envs import BatchedEnv as JaxBatchedEnv
from seed_rl_tpu.envs import ToyEnv as JaxToyEnv
from seed_rl_tpu.rollout import RolloutEngine as JaxRolloutEngine
from seed_rl_torch import distributions as tpd
from seed_rl_torch import optim, train
from seed_rl_torch.agents.ppo import continuous_control_agent as cca
from seed_rl_torch.agents.ppo import learner as ppo
from seed_rl_torch.envs import BatchedEnv, ToyEnv
from seed_rl_torch.models import convert
from seed_rl_torch.rollout import RolloutEngine
from seed_rl_torch.utils import episode_stats
from test_torch_ppo import UPDATE_TOL, _close, _jax_draws, _t, _torch_unroll

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "seed_rl_torch", "examples",
                       "custom_ppo_composition.py")
JAX_EXAMPLE = os.path.join(REPO, "scripts", "examples",
                           "custom_ppo_composition.py")
OPT_TOL = dict(rtol=1e-5, atol=1e-6)

# A small run of each agent on its vector env.
SMALL_RUNS = {
    "vtrace": ["--env=toy", "--num_envs=8", "--unroll_length=4",
               "--total_environment_frames=64"],
    "ppo": ["--env=toy", "--num_envs=8", "--unroll_length=4",
            "--epochs_per_step=1", "--batches_per_step=2",
            "--total_environment_frames=64"],
    "r2d2": ["--env=discrete_match", "--num_envs=8", "--unroll_length=4",
             "--burn_in=2", "--batch_size=8", "--replay_buffer_size=64",
             "--replay_buffer_min_size=16", "--total_environment_frames=96"],
    "sac": ["--env=toy", "--num_envs=4", "--unroll_length=2",
            "--batch_size=8", "--replay_buffer_size=64",
            "--replay_buffer_min_size=16", "--total_environment_frames=24"],
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread, so that the other test
    processes sharing the cores do not stall each op's thread barrier."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(path, name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_component_keys():
    """agent -> the sorted keys the JAX CLI's ``_apply_agent_module`` call
    passes in that agent's branch of ``seed_rl_tpu/train.py``."""
    with open(os.path.join(REPO, "seed_rl_tpu", "train.py")) as f:
        module = ast.parse(f.read())
    keys = {}
    for node in ast.walk(module):
        if not (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
                and ast.unparse(node.test.left) == "args.agent"):
            continue
        agent = node.test.comparators[0].value
        for inner in ast.walk(ast.Module(body=node.body, type_ignores=[])):
            if (isinstance(inner, ast.Call)
                    and ast.unparse(inner.func) == "_apply_agent_module"):
                keys[agent] = sorted(k.value for k in inner.args[2].keys)
    return keys


@pytest.mark.parametrize("spelling", ["path", "dotted"])
def test_example_module_composes_and_trains(tmp_path, spelling):
    """The port's example trains through the CLI: the 3x128 net, PopArt
    with compensation, and the cosine schedule at the update count."""
    module = (EXAMPLE if spelling == "path"
              else "seed_rl_torch.examples.custom_ppo_composition")
    learner, state, metrics = train.main([
        "--device=cpu", "--agent=ppo", "--env=toy", "--num_envs=16",
        "--unroll_length=4", "--epochs_per_step=1",
        "--batches_per_step=2", "--total_environment_frames=256",
        f"--agent_module={module}", f"--logdir={tmp_path}",
        "--steps_per_call=1",
    ])
    net = learner.agent.net
    assert isinstance(net, cca.ContinuousControlNet)
    assert [layer.out_features for layer in net.policy_torso.layers] == [
        128] * 3
    assert learner.loss.reward_normalizer.compensate
    assert state.step == 4 and learner.optimizer.count == 8
    assert learner.optimizer.learning_rate() == pytest.approx(
        3e-4 * 0.5 * (1 + math.cos(math.pi * 8 / 10_000)), rel=1e-12)
    assert all(math.isfinite(float(v)) for v in metrics.values())


@pytest.mark.parametrize("agent", sorted(SMALL_RUNS))
def test_hook_replaces_optimizer(tmp_path, agent):
    """A module that swaps only the optimizer is honoured, and its
    configure sees the keys the JAX CLI passes for the agent."""
    mod = tmp_path / "swap_opt.py"
    mod.write_text(
        "import functools\n"
        "from seed_rl_torch import optim\n"
        "CALLS = []\n"
        "def configure(args, env, components):\n"
        "    CALLS.append(sorted(components))\n"
        "    components['optimizer'] = functools.partial(\n"
        "        optim.ClippedAdam, learning_rate=1e-3)\n"
        "    return components\n"
    )
    learner, state, metrics = train.main(
        ["--device=cpu", f"--agent={agent}", f"--agent_module={mod}",
         "--steps_per_call=1"] + SMALL_RUNS[agent])
    assert learner.optimizer.learning_rate() == 1e-3
    assert learner.optimizer.clip_norm is None
    assert learner.optimizer.count > 0
    assert all(math.isfinite(float(v)) for v in metrics.values())


@pytest.mark.parametrize("agent", sorted(SMALL_RUNS))
def test_components_keys_are_the_jax_clis(tmp_path, monkeypatch, agent):
    """The components each agent's branch of the CLI hands to configure
    carry the JAX CLI's keys for that agent; a configure that returns None
    keeps its changes in place."""
    mod = tmp_path / "record.py"
    mod.write_text(
        "def configure(args, env, components):\n"
        "    args.seen_keys = sorted(components)\n"
    )
    seen = []
    real = train._apply_agent_module

    def recording(args, env, components):
        out = real(args, env, components)
        seen.append((args.seen_keys, out is components))
        return out

    monkeypatch.setattr(train, "_apply_agent_module", recording)
    train.main(["--device=cpu", f"--agent={agent}", f"--agent_module={mod}",
                "--total_environment_frames=0"] + SMALL_RUNS[agent][:-1])
    want = _jax_component_keys()[agent]
    assert "optimizer" in want and "net" in want
    assert seen == [(want, True)]


def test_hook_missing_configure_fails_loudly(tmp_path):
    mod = tmp_path / "empty.py"
    mod.write_text("x = 1\n")
    with pytest.raises(AttributeError, match="configure"):
        train.main([
            "--device=cpu", "--agent=vtrace", "--env=toy", "--num_envs=8",
            "--unroll_length=4", "--total_environment_frames=64",
            f"--agent_module={mod}",
        ])


def test_hook_missing_module_raises_import_error():
    with pytest.raises(ImportError):
        train.main(["--device=cpu", "--agent=ppo", "--env=toy",
                    "--agent_module=no_such_package.custom_composition"])


# -- the example's update against JAX's --------------------------------------

OBS, A = 4, 3


def _components(is_jax, args, env, optimizer):
    """The CLI's PPO components on the toy env, then the package's example
    module over them."""
    if is_jax:
        from seed_rl_tpu.train import _action_space_of

        dist = jpd.get_parametric_distribution_for_action_space(
            _action_space_of(env),
            jpd.continuous_action_config(action_gaussian_std_fn="safe_exp"))
        module = _load(JAX_EXAMPLE, "jax_custom_ppo_composition")
    else:
        dist = tpd.get_parametric_distribution_for_action_space(
            env.action_space,
            tpd.continuous_action_config(action_gaussian_std_fn="safe_exp"))
        module = _load(EXAMPLE, "torch_custom_ppo_composition")
    placeholder = (None if is_jax else cca.ContinuousControlNet(
        dist.param_size, OBS, num_layers_policy=1, num_layers_value=1,
        num_units_policy=4, num_units_value=4, device="cpu"))
    return module.configure(args, env, {
        "net": placeholder, "dist": dist, "agent": None, "loss": None,
        "config": None, "optimizer": optimizer})


def test_example_update_matches_jax():
    """One PPO update (split, 2 epochs x 2 minibatches) of the example's
    composition in both packages, from the same net parameters, loss
    parameters, statistics and unroll, with JAX's permutations and
    regularizer noise injected."""
    epochs, batches, B, T = 2, 2, 8, 4
    args = types.SimpleNamespace(discounting=0.9, clip_norm=0.5,
                                 learning_rate=3e-3)
    jenv = JaxBatchedEnv(JaxToyEnv(horizon=3), B)
    tenv = BatchedEnv(ToyEnv(horizon=3), B, device="cpu")
    jc = _components(True, args, jenv, None)
    tc = _components(False, args, tenv, None)
    mode = "split"
    jl = jlearner_mod.PPOLearner(
        JaxRolloutEngine(jenv, jc["agent"], T), jc["agent"], jc["loss"],
        jlearner_mod.PPOConfig(epochs_per_step=epochs, batch_mode=mode,
                               batches_per_step=batches), jc["optimizer"])
    tl = ppo.PPOLearner(
        RolloutEngine(tenv, tc["agent"], T), tc["agent"], tc["loss"],
        ppo.PPOConfig(epochs_per_step=epochs, batch_mode=mode,
                      batches_per_step=batches), tc["optimizer"])
    jstate = jax.jit(jl.init)(jax.random.PRNGKey(0))
    rollout = jax.jit(jl.engine.rollout)
    agent_params = jl.rollout_params(jstate)
    rollout_state, _ = rollout(agent_params, jstate.rollout)
    _, unroll = rollout(agent_params, rollout_state)
    step_rng = jax.random.PRNGKey(11)
    jnew, jlogs = jax.jit(jl.update)(jstate, unroll, step_rng)
    perms, noises = _jax_draws(mode, step_rng, epochs, batches, T * B,
                               (1, T * B // batches, A))

    params = jax.tree.map(np.asarray, jstate.params["net"])
    tl.agent.net.load_state_dict(convert.state_dict_for(tl.agent.net,
                                                        params))
    with torch.no_grad():
        for p, v in zip(jax.tree.leaves(tl.loss_params),
                        jax.tree.leaves(jstate.params["loss"])):
            p.copy_(_t(v))
    tl.agent.obs_norm = jax.tree.map(_t, jstate.obs_norm)
    state = tl.init()._replace(
        norm_state=jax.tree.map(_t, jstate.norm_state),
        stats=episode_stats.EpisodeStatsState(*map(_t, jstate.stats)))
    new, logs = tl.update(state, _torch_unroll(unroll),
                          permutations=[torch.tensor(p) for p in perms],
                          entropy_noise=[torch.tensor(n) for n in noises])
    assert tl.optimizer.count == epochs * batches
    assert set(logs) == set(jlogs)
    for k in logs:
        _close(logs[k], jlogs[k], UPDATE_TOL, k)
    want = convert.state_dict_for(tl.agent.net,
                                  jax.tree.map(np.asarray, jnew.params["net"]))
    for name, got in tl.agent.net.named_parameters():
        _close(got, want[name], UPDATE_TOL, f"updated {name}")
    _close(tl.loss_params, jnew.params["loss"], UPDATE_TOL, "loss params")
    _close(new.norm_state, jnew.norm_state, UPDATE_TOL, "PopArt state")


# -- ClippedAdam with a schedule and weight decay ----------------------------

def _grads(rng, shapes):
    return [rng.normal(size=s).astype(np.float32) * 3.0 for s in shapes]


def test_clipped_adamw_with_cosine_schedule_matches_optax():
    """Clip, Adam, decoupled weight decay, cosine-decayed lr (a short
    horizon, so the lr moves a lot over 3 steps): the parameters and the
    lr at each count against optax."""
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (4,), ()]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    lr, decay_steps, wd, clip = 0.1, 4, 0.3, 1.0
    tx = optax.chain(
        optax.clip_by_global_norm(clip),
        optax.adamw(optax.cosine_decay_schedule(lr, decay_steps=decay_steps),
                    weight_decay=wd))
    jparams = [jnp.asarray(x) for x in init]
    jopt = tx.init(jparams)
    params = [torch.tensor(x, requires_grad=True) for x in init]
    opt = optim.ClippedAdam(
        params, learning_rate=optim.cosine_decay_schedule(lr, decay_steps),
        clip_norm=clip, weight_decay=wd)
    schedule = optax.cosine_decay_schedule(lr, decay_steps=decay_steps)
    for step in range(3):
        grads = _grads(rng, shapes)
        np.testing.assert_allclose(opt.learning_rate(),
                                   float(schedule(step)), **OPT_TOL)
        updates, jopt = tx.update([jnp.asarray(g) for g in grads], jopt,
                                  jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(params, grads):
            p.grad = torch.tensor(g)
        opt.step()
        for p, w in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       **OPT_TOL, err_msg=f"step {step}")
    assert opt.count == 3


def test_clipped_adamw_resumes_bitwise_from_its_state_dict():
    """A ClippedAdam with a schedule and weight decay, restored from its
    state dict after 2 steps, takes the third step bit for bit as the
    uninterrupted one."""
    rng = np.random.RandomState(1)
    shapes = [(5,), (2, 3)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [_grads(rng, shapes) for _ in range(3)]

    def make(params):
        return optim.ClippedAdam(
            params, learning_rate=optim.cosine_decay_schedule(0.05, 10),
            clip_norm=2.0, weight_decay=1e-2)

    def step(opt, params, g):
        for p, x in zip(params, g):
            p.grad = torch.tensor(x)
        opt.step()

    a = [torch.tensor(x, requires_grad=True) for x in init]
    opt_a = make(a)
    for g in grads:
        step(opt_a, a, g)
    b = [torch.tensor(x, requires_grad=True) for x in init]
    opt_b = make(b)
    for g in grads[:2]:
        step(opt_b, b, g)
    c = [p.detach().clone().requires_grad_(True) for p in b]
    opt_c = make(c)
    opt_c.load_state_dict(opt_b.state_dict())
    assert opt_c.count == 2 and opt_c.learning_rate() == opt_b.learning_rate()
    step(opt_c, c, grads[2])
    for x, y in zip(a, c):
        assert torch.equal(x, y)


@pytest.mark.parametrize("transition_steps", [4, 0])
def test_linear_schedule_matches_optax(transition_steps):
    """The CLI's ``--lr_decay_multiplier`` schedule against optax's at
    every count through and past its end (flat at the initial value when
    there are no transition steps); exact to float64 rounding."""
    want = optax.linear_schedule(0.1, 0.025, transition_steps)
    got = optim.linear_schedule(0.1, 0.025, transition_steps)
    for count in range(7):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-7)
