"""Compute dtypes of the port's nets against the JAX package's, in bf16.

Each net with a dtype field is built in both packages at bfloat16, with the
JAX package's parameters carried over (models/convert.py: parameters stay
f32, each layer casts at use), and both see the same numpy inputs at a small
batch: one step and a time-major ``[T, B]`` unroll with resets inside it.

Tolerances. bf16 keeps 8 significant bits (a rounding step of up to 2^-8 of
a value); XLA rounds a layer's product and its bias sum separately where the
CPU's oneDNN kernels fuse them and round once, and the accumulation orders
differ, so each layer may differ by about one bf16 rounding step. Outputs
are held at ``BF16_TOL`` = rtol 2e-2 / atol 2e-2 of the output's largest
magnitude (about five steps at the scale of the output). The carry dtypes
must be equal; under bf16 gates the LSTM carry stays f32 in both, as flax's
``f * c + i * g`` promotes with the f32 carry. Each bf16 net's output must
also differ from the same net's f32 output by more than f32 noise
(``F32_NOISE`` = 1e-5 of its scale): a net that quietly stayed in f32 fails.

The SAME max pool in bf16 is held exactly (values and gradient, ties first
max) against JAX's in both pool settings, and ``remat`` gives the gradients
of the stored-activation path exactly.

Then one V-trace update with a bf16 ``AtariPolicyNet`` (LSTM in bf16 too)
and one R2D2 batch with a bf16 ``DuelingLSTMDQNNet`` against JAX: loss and
metrics within rtol 2e-2 / atol 2e-3, each gradient tensor within
``GRAD_REL`` = 5e-2 of its norm, the R2D2 priorities within rtol 2e-2, and
the parameters after the clip + Adam step within 2 lr + 1e-6 (Adam's first
step moves each weight by less than lr, whichever the gradient's rounding).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from seed_rl_tpu import distributions as jpd
from seed_rl_tpu.agent import PolicyAgent as JaxPolicyAgent
from seed_rl_tpu.agents import r2d2 as jax_r2d2
from seed_rl_tpu.agents import vtrace as jax_vtrace
from seed_rl_tpu.envs import BatchedEnv as JaxBatchedEnv
from seed_rl_tpu.envs.catch import CatchEnv as JaxCatchEnv
from seed_rl_tpu.models import atari as jax_atari
from seed_rl_tpu.models import core as jax_core
from seed_rl_tpu.models import resnets as jax_resnets
from seed_rl_tpu.models import sac_nets as jax_sac_nets
from seed_rl_tpu.ops import pooling as jax_pooling
from seed_rl_tpu.rollout import RolloutEngine as JaxRolloutEngine
from seed_rl_torch import distributions as tpd
from seed_rl_torch import optim
from seed_rl_torch.agent import PolicyAgent
from seed_rl_torch.agents import r2d2, vtrace
from seed_rl_torch.envs import BatchedEnv, CatchEnv
from seed_rl_torch.envs.core import TensorSpec
from seed_rl_torch.models import (
    AgentState,
    AtariPolicyNet,
    DuelingLSTMDQNNet,
    GFootball,
    ImpalaDeep,
    VisualActorCritic,
    convert,
)
from seed_rl_torch.models.core import LSTMCell, LSTMStack, MLPTorso
from seed_rl_torch.ops.pooling import max_pool_same
from seed_rl_torch.replay import ReplayState
from seed_rl_torch.rollout import RolloutEngine, Timestep, Unroll
from seed_rl_torch.types import AgentOutput, EnvOutput, QAgentOutput

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
F32_NOISE = 1e-5
LOSS_TOL = dict(rtol=2e-2, atol=2e-3)
GRAD_REL = 5e-2
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what=""):
    """bf16 closeness: rtol, and atol relative to the output's scale."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL["rtol"],
                               atol=BF16_TOL["atol"] * scale, err_msg=what)


def _differs(bf16_out, f32_out, what=""):
    a, b = _np(bf16_out), _np(f32_out)
    scale = max(float(np.abs(b).max()), 1e-6)
    assert float(np.abs(a - b).max()) > F32_NOISE * scale, (
        f"{what}: the bf16 net computes what the f32 net computes")


def _env_output(rng, lead, obs_shape, obs_dtype=np.uint8, done_p=0.0):
    high = 2 ** 16 if obs_dtype == np.uint16 else 256
    return dict(
        reward=rng.normal(size=lead).astype(np.float32) * 2,
        done=rng.uniform(size=lead) < done_p,
        observation=rng.randint(0, high, lead + obs_shape).astype(obs_dtype),
        abandoned=np.zeros(lead, bool),
        episode_step=np.zeros(lead, np.int32),
    )


def _jeo(eo):
    from seed_rl_tpu.types import EnvOutput as JaxEnvOutput

    return JaxEnvOutput(**{k: jnp.asarray(v) for k, v in eo.items()})


def _teo(eo):
    return EnvOutput(**{k: torch.from_numpy(v) for k, v in eo.items()})


def _load(tnet, params):
    tnet.load_state_dict(
        convert.state_dict_for(tnet, jax.tree.map(np.asarray, params)),
        strict=True)


def _dtypes(tree):
    return [x.dtype for x in jax.tree.leaves(tree)]


def _jdtypes(tree):
    return [torch.float32 if x.dtype == jnp.float32 else
            BF16 if x.dtype == jnp.bfloat16 else x.dtype
            for x in jax.tree.leaves(tree)]


# -- the building blocks ----------------------------------------------------


def test_mlp_torso_and_lstm_stack_in_bf16_match_flax():
    """MLPTorso(dtype=bf16) returns bf16, as JAX's does; an LSTMStack fed
    with it computes in the promoted dtype (f32, flax's default) and keeps
    an f32 carry."""
    rng = np.random.RandomState(0)
    B, width = 5, 12
    x = rng.normal(size=(B, 7)).astype(np.float32)
    done = np.array([False, True, False, True, False])
    carry = ((rng.normal(size=(B, width)).astype(np.float32),
              rng.normal(size=(B, width)).astype(np.float32)),)
    jtorso = jax_core.MLPTorso((16, 8), dtype=jnp.bfloat16)
    tparams = jtorso.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jstack = jax_core.LSTMStack((width,))
    jout = jtorso.apply(tparams, jnp.asarray(x))
    sparams = jstack.init(jax.random.PRNGKey(1), jout,
                          jax.tree.map(jnp.asarray, carry), jnp.asarray(done))
    jh, jcarry = jstack.apply(sparams, jout, jax.tree.map(jnp.asarray, carry),
                              jnp.asarray(done))

    gen = torch.Generator().manual_seed(0)
    torso = MLPTorso(7, (16, 8), "relu", gen, dtype=BF16)
    torso_f32 = MLPTorso(7, (16, 8), "relu", gen)
    for i, layer in enumerate(jax.tree.map(np.asarray,
                                           tparams["params"]).values()):
        for net in (torso, torso_f32):
            net.layers[i].weight.data = torch.tensor(layer["kernel"].T)
            net.layers[i].bias.data = torch.tensor(layer["bias"])
    stack = LSTMStack(8, (width,), gen)
    cell = jax.tree.map(np.asarray, sparams["params"]["lstm_0"])
    stack.cells[0].load_state_dict(_cell_state(cell))
    out = torso(torch.from_numpy(x))
    assert out.dtype == BF16 and jout.dtype == jnp.bfloat16
    _close(out, jout, "MLPTorso")
    _differs(out, torso_f32(torch.from_numpy(x)), "MLPTorso")
    h, new_carry = stack(out, jax.tree.map(torch.from_numpy, carry),
                         torch.from_numpy(done))
    assert h.dtype == torch.float32 and jh.dtype == jnp.float32
    assert _dtypes(new_carry) == _jdtypes(jcarry) == [torch.float32] * 2
    _close(h, jh, "LSTMStack output")
    for g, w in zip(jax.tree.leaves(new_carry), jax.tree.leaves(jcarry)):
        _close(g, w, "LSTMStack carry")


def _cell_state(cell):
    """flax OptimizedLSTMCell params -> the port's fused LSTMCell."""
    gates = "ifgo"
    return {
        "weight_ih": torch.from_numpy(np.concatenate(
            [cell[f"i{g}"]["kernel"] for g in gates], axis=1).T.copy()),
        "weight_hh": torch.from_numpy(np.concatenate(
            [cell[f"h{g}"]["kernel"] for g in gates], axis=1).T.copy()),
        "bias": torch.from_numpy(np.concatenate(
            [cell[f"h{g}"]["bias"] for g in gates])),
    }


def test_lstm_cell_with_bf16_gates_keeps_an_f32_carry_as_flax_does():
    import flax.linen as fnn

    rng = np.random.RandomState(1)
    B, n_in, width = 4, 9, 16
    x = rng.normal(size=(B, n_in)).astype(np.float32)
    carry = (rng.normal(size=(B, width)).astype(np.float32),
             rng.normal(size=(B, width)).astype(np.float32))
    jcell = fnn.OptimizedLSTMCell(width, dtype=jnp.bfloat16)
    params = jcell.init(jax.random.PRNGKey(0),
                        jax.tree.map(jnp.asarray, carry), jnp.asarray(x))
    (jc, jh), jout = jcell.apply(params, jax.tree.map(jnp.asarray, carry),
                                 jnp.asarray(x))
    cell = LSTMCell(n_in, width, torch.Generator().manual_seed(0), BF16)
    cell_f32 = LSTMCell(n_in, width, torch.Generator().manual_seed(0))
    state = _cell_state(jax.tree.map(np.asarray, params["params"]))
    cell.load_state_dict(state)
    cell_f32.load_state_dict(state)
    tcarry = tuple(map(torch.from_numpy, carry))
    (c, h), out = cell(tcarry, torch.from_numpy(x))
    assert (c.dtype, h.dtype, out.dtype) == (torch.float32,) * 3
    assert (jc.dtype, jh.dtype) == (jnp.float32,) * 2
    _close(c, jc, "c")
    _close(h, jh, "h")
    _differs(h, cell_f32(tcarry, torch.from_numpy(x))[1], "LSTMCell")


@pytest.mark.parametrize("custom_pool_bwd", [True, False])
def test_same_pool_in_bf16_keeps_the_first_max_tie_rule(custom_pool_bwd):
    rng = np.random.RandomState(2)
    # Few levels, so that windows tie; odd sizes pad asymmetrically.
    x = (rng.randint(0, 4, (2, 11, 9, 3)) * 0.5).astype(np.float32)
    g = rng.normal(size=(2, 6, 5, 3)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)

    def jpool(v):
        if custom_pool_bwd:
            return jax_pooling.max_pool_same(v, (3, 3), (2, 2))
        import flax.linen as fnn

        return fnn.max_pool(v, (3, 3), strides=(2, 2), padding="SAME")

    jout, vjp = jax.vjp(jpool, jx)
    (jgrad,) = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.from_numpy(x).to(BF16).permute(0, 3, 1, 2).requires_grad_()
    out = max_pool_same(tx, (3, 3), (2, 2))
    assert out.dtype == BF16
    (grad,) = torch.autograd.grad(
        out, tx, torch.from_numpy(g).to(BF16).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(_np(out.permute(0, 2, 3, 1)), _np(jout))
    np.testing.assert_array_equal(_np(grad.permute(0, 2, 3, 1)), _np(jgrad))


# -- the nets -------------------------------------------------------------


def _atari_state(rng, B, frame_shape, stack_size, lstm_size):
    core = ((rng.normal(size=(B, lstm_size)).astype(np.float32),
             rng.normal(size=(B, lstm_size)).astype(np.float32)),)
    frames = rng.randint(0, 256, (B,) + frame_shape + (stack_size - 1,)
                         ).astype(np.uint8)
    return core, frames


def _step_and_unroll(jnet, jagent, tnet, tagent, tnet_f32, tagent_f32,
                     params, frame_shape, lstm_size, num_actions):
    rng = np.random.RandomState(3)
    B, T = 3, 5
    core, frames = _atari_state(rng, B, frame_shape, 4, lstm_size)

    def states():
        return (jax_atari.AgentState(jax.tree.map(jnp.asarray, core),
                                     jnp.asarray(frames)),
                AgentState(jax.tree.map(torch.from_numpy, core),
                           torch.from_numpy(frames)))

    eo = _env_output(rng, (B,), frame_shape + (1,), done_p=0.4)
    prev = rng.randint(0, num_actions, B).astype(np.int32)
    jstate, tstate = states()
    jout, jnew = jnet.apply(params, jnp.asarray(prev), _jeo(eo), jstate)
    tout, tnew = tnet(torch.from_numpy(prev), _teo(eo), tstate)
    f32_out, _ = tnet_f32(torch.from_numpy(prev), _teo(eo), states()[1])
    yield "step", jout, jnew, tout, tnew, f32_out

    eo = _env_output(rng, (T, B), frame_shape + (1,), done_p=0.3)
    eo["done"][2, :2] = True
    prev = rng.randint(0, num_actions, (T, B)).astype(np.int32)
    jstate, tstate = states()
    jout, jnew = jagent.unroll(params, jnp.asarray(prev), _jeo(eo), jstate)
    tout, tnew = tagent.unroll(torch.from_numpy(prev), _teo(eo), tstate)
    f32_out, _ = tagent_f32.unroll(torch.from_numpy(prev), _teo(eo),
                                   states()[1])
    yield "unroll", jout, jnew, tout, tnew, f32_out


def _check_state(tnew, jnew, what):
    assert _dtypes(tnew.core_state) == _jdtypes(jnew.core_state) == [
        torch.float32] * 2, what
    for g, w in zip(jax.tree.leaves(tnew.core_state),
                    jax.tree.leaves(jnew.core_state)):
        _close(g, w, f"{what} carry")
    np.testing.assert_array_equal(tnew.frame_stacking_state.numpy(),
                                  np.asarray(jnew.frame_stacking_state))


def test_atari_policy_net_in_bf16_matches_flax():
    frame_shape, lstm_size, actions = (84, 84), 32, 6
    kw = dict(frame_shape=frame_shape, stack_size=4, lstm_size=lstm_size)
    jnet = jax_atari.AtariPolicyNet(actions, **kw, dtype=jnp.bfloat16,
                                    core_dtype=jnp.bfloat16)
    rng = np.random.RandomState(0)
    params = jnet.init(jax.random.PRNGKey(1), jnp.zeros((2,), jnp.int32),
                       _jeo(_env_output(rng, (2,), frame_shape + (1,))),
                       jnet.initial_state(2))
    tnet = AtariPolicyNet(actions, **kw, dtype=BF16, core_dtype=BF16,
                          device="cpu")
    tnet_f32 = AtariPolicyNet(actions, **kw, device="cpu")
    _load(tnet, params)
    _load(tnet_f32, params)
    dist = tpd.CategoricalDistribution(actions)
    for what, jout, jnew, tout, tnew, f32_out in _step_and_unroll(
            jnet, JaxPolicyAgent(jnet, jpd.CategoricalDistribution(actions)),
            tnet, PolicyAgent(tnet, dist), tnet_f32,
            PolicyAgent(tnet_f32, dist), params, frame_shape, lstm_size,
            actions):
        for name, g, w, f in zip(("logits", "baseline"), tout, jout,
                                 f32_out):
            assert g.dtype == torch.float32 and w.dtype == jnp.float32
            _close(g, w, f"{what} {name}")
            _differs(g, f, f"{what} {name}")
        _check_state(tnew, jnew, what)


def test_dueling_lstm_dqn_net_in_bf16_matches_flax():
    frame_shape, lstm_size, actions = (84, 84), 32, 5
    kw = dict(frame_shape=frame_shape, lstm_size=lstm_size)
    jnet = jax_atari.DuelingLSTMDQNNet(actions, **kw, dtype=jnp.bfloat16,
                                       core_dtype=jnp.bfloat16)
    rng = np.random.RandomState(0)
    params = jnet.init(jax.random.PRNGKey(1), jnp.zeros((2,), jnp.int32),
                       _jeo(_env_output(rng, (2,), frame_shape + (1,))),
                       jnet.initial_state(2))
    tnet = DuelingLSTMDQNNet(actions, **kw, dtype=BF16, core_dtype=BF16,
                             device="cpu")
    tnet_f32 = DuelingLSTMDQNNet(actions, **kw, device="cpu")
    _load(tnet, params)
    _load(tnet_f32, params)

    class JaxUnroll:  # the JAX agent's unroll is the net's time-major path
        def unroll(self, params, prev, eo, state):
            return jnet.apply(params, prev, eo, state,
                              method=jnet.unroll_time_major)

    class Unroller:
        def __init__(self, net):
            self.unroll = net.unroll

    for what, jout, jnew, tout, tnew, f32_out in _step_and_unroll(
            jnet, JaxUnroll(), tnet, Unroller(tnet), tnet_f32,
            Unroller(tnet_f32), params, frame_shape, lstm_size, actions):
        assert tout.q_values.dtype == torch.float32
        assert jout.q_values.dtype == jnp.float32
        _close(tout.q_values, jout.q_values, f"{what} q")
        _differs(tout.q_values, f32_out.q_values, f"{what} q")
        _check_state(tnew, jnew, what)


@pytest.mark.parametrize("remat", [False, True])
def test_impala_deep_in_bf16_matches_flax(remat):
    obs_shape, actions, lstm = (24, 20, 3), 4, 16
    jnet = jax_resnets.ImpalaDeep(num_actions=actions, lstm_size=lstm,
                                  dtype=jnp.bfloat16)
    rng = np.random.RandomState(0)
    params = jnet.init(jax.random.PRNGKey(1), jnp.zeros((2,), jnp.int32),
                       _jeo(_env_output(rng, (2,), obs_shape)),
                       jnet.initial_state(2))
    tnet = ImpalaDeep(actions, obs_shape, lstm_size=lstm, remat=remat,
                      dtype=BF16, device="cpu")
    tnet_f32 = ImpalaDeep(actions, obs_shape, lstm_size=lstm, device="cpu")
    _load(tnet, params)
    _load(tnet_f32, params)
    B, T = 3, 4
    core = ((rng.normal(size=(B, lstm)).astype(np.float32),
             rng.normal(size=(B, lstm)).astype(np.float32)),)
    eo = _env_output(rng, (B,), obs_shape, done_p=0.5)
    prev = rng.randint(0, actions, B).astype(np.int32)
    (jl, jb), jnew = jnet.apply(params, jnp.asarray(prev), _jeo(eo),
                                jax.tree.map(jnp.asarray, core))
    (tl, tb), tnew = tnet(torch.from_numpy(prev), _teo(eo),
                          jax.tree.map(torch.from_numpy, core))
    (fl, _), _ = tnet_f32(torch.from_numpy(prev), _teo(eo),
                          jax.tree.map(torch.from_numpy, core))
    _close(tl, jl, "step logits")
    _close(tb, jb, "step baseline")
    _differs(tl, fl, "step logits")
    assert _dtypes(tnew) == _jdtypes(jnew) == [torch.float32] * 2

    eo = _env_output(rng, (T, B), obs_shape, done_p=0.3)
    prev = rng.randint(0, actions, (T, B)).astype(np.int32)
    jagent = JaxPolicyAgent(jnet, jpd.CategoricalDistribution(actions))
    (jl, jb), jnew = jagent.unroll(params, jnp.asarray(prev), _jeo(eo),
                                   jax.tree.map(jnp.asarray, core))
    (tl, tb), tnew = tnet.unroll(torch.from_numpy(prev), _teo(eo),
                                 jax.tree.map(torch.from_numpy, core))
    _close(tl, jl, "unroll logits")
    _close(tb, jb, "unroll baseline")
    assert _dtypes(tnew) == _jdtypes(jnew) == [torch.float32] * 2
    if remat:  # the stored-activation path's gradients, exactly
        stored = ImpalaDeep(actions, obs_shape, lstm_size=lstm, dtype=BF16,
                            device="cpu")
        _load(stored, params)
        grads = []
        for net in (tnet, stored):
            (logits, base), _ = net.unroll(
                torch.from_numpy(prev), _teo(eo),
                jax.tree.map(torch.from_numpy, core))
            loss = torch.sum(logits ** 2) + torch.sum(base ** 2)
            grads.append(torch.autograd.grad(loss, list(net.parameters())))
        for g, w in zip(*grads):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_gfootball_in_bf16_matches_flax():
    obs_shape, B = (18, 24, 1), 3
    jnet = jax_resnets.GFootball(parametric_distribution_param_size=19,
                                 dtype=jnp.bfloat16)
    rng = np.random.RandomState(1)
    eo = _env_output(rng, (B,), obs_shape, obs_dtype=np.uint16)
    prev = np.zeros(B, np.int32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(prev), _jeo(eo), ())
    (jl, jb), _ = jnet.apply(params, jnp.asarray(prev), _jeo(eo), ())
    tnet = GFootball(19, observation_shape=obs_shape, dtype=BF16,
                     device="cpu")
    tnet_f32 = GFootball(19, observation_shape=obs_shape, device="cpu")
    _load(tnet, params)
    _load(tnet_f32, params)
    (tl, tb), state = tnet(torch.from_numpy(prev), _teo(eo), ())
    (fl, _), _ = tnet_f32(torch.from_numpy(prev), _teo(eo), ())
    assert state == () and tl.dtype == torch.float32
    _close(tl, jl, "logits")
    _close(tb, jb, "baseline")
    _differs(tl, fl, "logits")


def test_visual_actor_critic_with_a_bf16_torso_matches_flax():
    spec = TensorSpec((42, 42, 1), torch.uint8)
    jnet = jax_sac_nets.VisualActorCritic(4, conv_dtype=jnp.bfloat16)
    rng = np.random.RandomState(2)
    B, T = 3, 2
    eo = _env_output(rng, (B,), (42, 42, 1))
    action = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(action), _jeo(eo),
                       ())
    tnet = VisualActorCritic(4, spec, conv_dtype=BF16, device="cpu")
    tnet_f32 = VisualActorCritic(4, spec, device="cpu")
    _load(tnet, params)
    _load(tnet_f32, params)
    for lead in ((B,), (T, B)):
        eo = _env_output(rng, lead, (42, 42, 1))
        action = rng.uniform(-1, 1, lead + (2,)).astype(np.float32)
        jargs = (jnp.zeros(lead + (2,)), _jeo(eo), ())
        targs = (torch.zeros(lead + (2,)), _teo(eo), ())
        emb = tnet.get_embedding(*targs)
        assert emb.dtype == torch.float32
        _close(emb, jnet.apply(params, *jargs, method=jnet.get_embedding),
               f"embedding {lead}")
        _differs(emb, tnet_f32.get_embedding(*targs), "embedding")
        _close(tnet.get_action_params(*targs),
               jnet.apply(params, *jargs, method=jnet.get_action_params),
               f"actor {lead}")
        _close(tnet.get_q(*targs, torch.from_numpy(action)),
               jnet.apply(params, *jargs, jnp.asarray(action),
                          method=jnet.get_q), f"q {lead}")


# -- one update of each agent from Catch frames ---------------------------

CATCH = dict(rows=6, cols=6, cell_pixels=6, balls_per_episode=2)  # 36x36


def _t(x):
    return torch.tensor(np.asarray(x))


def _torch_state(state):
    if isinstance(state, jax_atari.AgentState):
        return AgentState(*(jax.tree.map(_t, part) for part in state))
    return jax.tree.map(_t, state)


def _grads_close(grads, names, want, what):
    for name, got in zip(names, grads):
        w = want[name].numpy()
        err = np.linalg.norm(got.float().numpy() - w)
        assert err <= GRAD_REL * max(np.linalg.norm(w), 1e-8), (
            f"{what} {name}: |diff| {err:.3e}, |want| "
            f"{np.linalg.norm(w):.3e}")


def _updated_close(net, params, lr, what):
    want = convert.state_dict_for(net, jax.tree.map(np.asarray, params))
    for name, got in net.named_parameters():
        np.testing.assert_allclose(got.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=2 * lr + 1e-6,
                                   err_msg=f"{what} {name}")


def test_vtrace_update_with_a_bf16_atari_policy_net_matches_jax():
    B, T, lr, actions = 6, 8, 1e-3, 3
    kw = dict(frame_shape=(36, 36), stack_size=3, lstm_size=16)
    jnet = jax_atari.AtariPolicyNet(actions, **kw, dtype=jnp.bfloat16,
                                    core_dtype=jnp.bfloat16)
    tnet = AtariPolicyNet(actions, **kw, dtype=BF16, core_dtype=BF16,
                          device="cpu")
    config = dict(entropy_cost=0.01, discounting=0.95)
    jconfig = jax_vtrace.VTraceConfig(**config)
    tconfig = vtrace.VTraceConfig(**config)
    jdist = jpd.CategoricalDistribution(actions)
    jagent = JaxPolicyAgent(jnet, jdist)
    jengine = JaxRolloutEngine(JaxBatchedEnv(JaxCatchEnv(**CATCH), B),
                               jagent, T)
    jlearner = jax_vtrace.VTraceLearner(
        jengine, jagent, jconfig,
        optax.chain(optax.clip_by_global_norm(40.0), optax.adam(lr)))
    jstate = jlearner.init(jax.random.PRNGKey(0))
    rollout = jax.jit(jengine.rollout)
    _, unroll = rollout(jstate.params["net"],
                        rollout(jstate.params["net"], jstate.rollout)[0])
    assert bool(jnp.any(unroll.timesteps.env_output.done))
    loss_rng = jax.random.PRNGKey(7)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jax_vtrace.compute_loss, jconfig, jagent, jdist),
        has_aux=True))(jstate.params, unroll, loss_rng)
    jnew, _ = jax.jit(jlearner.update)(jstate, unroll, loss_rng)

    state_dict, entropy_cost = convert.vtrace_params(
        tnet, jax.tree.map(np.asarray, jstate.params))
    tnet.load_state_dict(state_dict, strict=True)
    tagent = PolicyAgent(tnet, tpd.CategoricalDistribution(actions))
    tlearner = vtrace.VTraceLearner(
        RolloutEngine(BatchedEnv(CatchEnv(**CATCH), B, device="cpu"),
                      tagent, T),
        tagent, tconfig,
        functools.partial(optim.ClippedAdam, learning_rate=lr,
                          clip_norm=40.0))
    with torch.no_grad():
        tlearner.entropy_cost.copy_(entropy_cost)
    ts = unroll.timesteps
    tunroll = Unroll(
        agent_state=_torch_state(unroll.agent_state),
        timesteps=Timestep(prev_action=_t(ts.prev_action),
                           env_output=EnvOutput(*map(_t, ts.env_output)),
                           agent_output=AgentOutput(*map(_t,
                                                         ts.agent_output))))
    # The V-trace kernel's inputs stay f32 under a bf16 net.
    inputs, _ = vtrace.vtrace_inputs(tconfig, tagent, tagent.distribution,
                                     tunroll)
    assert {x.dtype for x in inputs.values()
            if isinstance(x, torch.Tensor)} == {torch.float32}
    loss, metrics = vtrace.compute_loss(
        tconfig, tagent, tagent.distribution, tlearner.entropy_cost, tunroll)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **LOSS_TOL, err_msg=k)
    grads = torch.autograd.grad(loss, list(tnet.parameters()))
    assert all(g.dtype == torch.float32 for g in grads)
    want, _ = convert.vtrace_params(tnet, jax.tree.map(np.asarray, jgrads))
    _grads_close(grads, [n for n, _ in tnet.named_parameters()], want,
                 "vtrace grad")
    tlearner.update(tlearner.init(), tunroll)
    want, _ = convert.vtrace_params(tnet, jax.tree.map(np.asarray,
                                                       jnew.params))
    for name, got in tnet.named_parameters():
        np.testing.assert_allclose(got.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=2 * lr + 1e-6,
                                   err_msg=f"updated {name}")


def test_r2d2_batch_with_a_bf16_dueling_lstm_dqn_net_matches_jax():
    A, frame, lstm, lr = 3, (36, 36), 32, 1e-3
    num_envs, num_eval, unroll_length, burn_in = 5, 1, 6, 2
    env = JaxBatchedEnv(JaxCatchEnv(**CATCH), num_envs)
    jnet = jax_atari.DuelingLSTMDQNNet(num_actions=A, frame_shape=frame,
                                       lstm_size=lstm, dtype=jnp.bfloat16,
                                       core_dtype=jnp.bfloat16)
    epsilons = jnp.concatenate([jax_r2d2.training_env_epsilons(4),
                                jnp.full((num_eval,), 1e-3)])
    jagent = jax_r2d2.R2D2Agent(jnet, epsilons)
    jengine = JaxRolloutEngine(env, jagent, unroll_length,
                               num_overlapping_steps=burn_in)
    config = jax_r2d2.R2D2Config(
        discounting=0.9, n_steps=3, burn_in=burn_in, replay_buffer_size=16,
        replay_buffer_min_size=8, batch_size=6, num_eval_envs=num_eval)
    jlearner = jax_r2d2.R2D2Learner(
        jengine, jagent, config,
        optax.chain(optax.clip_by_global_norm(0.05), optax.adam(lr)))
    jstate = jax.jit(jlearner.init)(jax.random.PRNGKey(0))
    warmup = jax.jit(jlearner.warmup_step)
    for _ in range(2):
        jstate = warmup(jstate)
    target_params = jlearner.agent.init_params(
        jax.random.PRNGKey(9), jnp.zeros((num_envs,), jnp.int32),
        env.reset(jax.random.PRNGKey(1))[1])
    carry = (jstate.params, target_params, jstate.opt_state, jstate.replay,
             jax.random.PRNGKey(4))
    _, sample_rng = jax.random.split(carry[-1])
    jidx, jweights, jbatch = jlearner.replay.sample(
        jstate.replay, sample_rng, config.batch_size,
        config.priority_exponent)
    (params, _, _, jreplay, _), jlogs = jax.jit(jlearner._train_on_batch)(
        carry, None)

    def jax_loss(p):
        tm = jax.tree.map(lambda t: jnp.swapaxes(t, 0, 1),
                          (jbatch.prev_actions, jbatch.env_outputs,
                           jbatch.agent_outputs))
        loss, _ = jax_r2d2.compute_loss_and_priorities(
            jagent, p, target_params, jbatch.agent_state, *tm,
            gamma=config.discounting, burn_in=burn_in,
            n_steps=config.n_steps)
        return jnp.mean(loss * jweights)

    jgrads = jax.jit(jax.grad(jax_loss))(jstate.params)

    tnet = DuelingLSTMDQNNet(A, frame_shape=frame, lstm_size=lstm,
                             dtype=BF16, core_dtype=BF16, device="cpu")
    tagent = r2d2.R2D2Agent(tnet, _t(epsilons))
    tengine = RolloutEngine(BatchedEnv(CatchEnv(**CATCH), num_envs,
                                       device="cpu"),
                            tagent, unroll_length,
                            num_overlapping_steps=burn_in)
    tconfig = r2d2.R2D2Config(**{
        f: getattr(config, f) for f in r2d2.R2D2Config.__dataclass_fields__})
    learner = r2d2.R2D2Learner(
        tengine, tagent, tconfig,
        functools.partial(optim.ClippedAdam, learning_rate=lr,
                          clip_norm=0.05))
    _load(learner.net, jstate.params)
    _load(learner.target_net, target_params)
    assert learner.target_net.torso.dtype == BF16
    buf = jlearner.replay._unflatten_batch(jstate.replay.buffer)
    replay = ReplayState(
        buffer=r2d2.StoredUnroll(
            agent_state=_torch_state(buf.agent_state),
            prev_actions=_t(buf.prev_actions),
            env_outputs=EnvOutput(*map(_t, buf.env_outputs)),
            agent_outputs=QAgentOutput(*map(_t, buf.agent_outputs))),
        priorities=_t(jstate.replay.priorities),
        insert_index=int(jstate.replay.insert_index),
        num_inserted=int(jstate.replay.num_inserted))
    state = learner.init()._replace(replay=replay)
    indices = _t(jidx)
    _, weights, batch = learner.replay.sample(
        replay, None, config.batch_size, config.priority_exponent,
        indices=indices)
    tm = r2d2._time_major((batch.prev_actions, batch.env_outputs,
                           batch.agent_outputs))
    # The n-step kernel's inputs stay f32 under a bf16 net.
    q_inputs = r2d2.loss_inputs(learner.net, learner.target_net,
                                batch.agent_state, *tm, burn_in=burn_in)
    assert {x.dtype for x in jax.tree.leaves(q_inputs)
            if torch.is_floating_point(x)} == {torch.float32}
    loss, _ = r2d2.compute_loss_and_priorities(
        learner.net, learner.target_net, batch.agent_state, *tm,
        gamma=config.discounting, burn_in=burn_in, n_steps=config.n_steps)
    grads = torch.autograd.grad(torch.mean(loss * weights),
                                learner.parameters())
    want = convert.state_dict_for(learner.net,
                                  jax.tree.map(np.asarray, jgrads))
    _grads_close(grads, [n for n, _ in learner.net.named_parameters()],
                 want, "r2d2 grad")
    state, logs = learner.train_on_batch(state, indices=indices)
    assert set(logs) == set(jlogs)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                   **LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(state.replay.priorities.numpy(),
                               jreplay.priorities, rtol=2e-2, atol=1e-3)
    _updated_close(learner.net, params, lr, "updated")
