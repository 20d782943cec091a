"""The port's prioritized replay (seed_rl_torch.replay) against JAX.

Mirrors the prioritized cases of tests/test_replay.py (FIFO wrap-around,
priority-respecting sampling, uniform sampling at exponent 0, the
importance-weight formula, priority updates, multi-axis items), and holds
the importance weights against ``seed_rl_tpu.replay`` on the same buffer
with JAX's draw injected as the indices (rtol 1e-5: float32, one rounding
of 1/limit apart). The contract checks raise only with debug asserts on.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from seed_rl_tpu.replay import PrioritizedReplay as JaxPrioritizedReplay
from seed_rl_torch.replay import PrioritizedReplay
from seed_rl_torch.utils import debug_asserts


def _generator(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_insert_wraps_around_fifo():
    replay = PrioritizedReplay(size=4, importance_sampling_exponent=0.6)
    state = replay.init_state(torch.zeros((2,)))
    values = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    state, idx1 = replay.insert(state, values[:3], torch.ones((3,)))
    assert idx1.tolist() == [0, 1, 2]
    state, idx2 = replay.insert(state, values[3:],
                                torch.tensor([2.0, 3.0, 4.0]))
    assert idx2.tolist() == [3, 0, 1]
    # Slots 0, 1 were overwritten by items 4, 5.
    torch.testing.assert_close(state.buffer[0], values[4])
    torch.testing.assert_close(state.buffer[1], values[5])
    torch.testing.assert_close(state.buffer[2], values[2])
    assert state.priorities.tolist() == [3.0, 4.0, 1.0, 2.0]
    assert state.num_inserted == 4  # saturates at size
    assert state.insert_index == 2
    with pytest.raises(ValueError):
        replay.insert(state, torch.zeros((5, 2)), torch.ones((5,)))


def test_sample_respects_priorities():
    replay = PrioritizedReplay(size=4, importance_sampling_exponent=0.0)
    state = replay.init_state(torch.zeros(()))
    state, _ = replay.insert(state, torch.arange(4, dtype=torch.float32),
                             torch.tensor([1.0, 0.0, 0.0, 3.0]))
    _, _, items = replay.sample(state, _generator(0), 4000, priority_exp=1.0)
    freqs = np.bincount(items.numpy().astype(np.int64), minlength=4) / 4000
    np.testing.assert_allclose(freqs, [0.25, 0.0, 0.0, 0.75], atol=0.03)


def test_sample_uniform_when_exp_zero():
    replay = PrioritizedReplay(size=8, importance_sampling_exponent=0.6)
    state = replay.init_state(torch.zeros(()))
    state, _ = replay.insert(state, torch.arange(4, dtype=torch.float32),
                             torch.tensor([9.0, 1.0, 1.0, 1.0]))
    idx, weights, _ = replay.sample(state, _generator(1), 4000,
                                    priority_exp=0)
    # Only the 4 inserted slots are sampled, roughly uniformly.
    freqs = np.bincount(idx.numpy(), minlength=8) / 4000
    assert np.all(freqs[4:] == 0)
    np.testing.assert_allclose(freqs[:4], 0.25, atol=0.04)
    assert torch.all(weights == 1.0)


@pytest.mark.parametrize("num_inserted", [3, 6])
def test_importance_weights_match_jax_with_injected_indices(num_inserted):
    exp, priority_exp, size = 0.6, 0.9, 6
    priorities = np.array([1.0, 2.0, 3.0, 4.0, 0.5, 7.0],
                          np.float32)[:num_inserted]
    values = np.arange(num_inserted * 2, dtype=np.float32).reshape(-1, 2)

    jreplay = JaxPrioritizedReplay(size, exp)
    jstate = jreplay.init_state(jnp.zeros((2,)))
    jstate, _ = jreplay.insert(jstate, jnp.asarray(values),
                               jnp.asarray(priorities))
    jidx, jweights, jitems = jreplay.sample(
        jstate, jax.random.PRNGKey(2), 64, priority_exp)

    replay = PrioritizedReplay(size, exp)
    state = replay.init_state(torch.zeros((2,)))
    state, _ = replay.insert(state, torch.from_numpy(values),
                             torch.from_numpy(priorities))
    idx, weights, items = replay.sample(
        state, None, 64, priority_exp,
        indices=torch.from_numpy(np.array(jidx)))
    assert idx.tolist() == np.asarray(jidx).tolist()
    np.testing.assert_allclose(weights.numpy(), jweights, rtol=1e-5)
    np.testing.assert_array_equal(items.numpy(), jitems)
    # The reference formula (tests/test_replay.py).
    prob = priorities.astype(np.float64) ** priority_exp
    prob /= prob.sum()
    want = ((1.0 / num_inserted) / prob[np.asarray(jidx)]) ** exp
    np.testing.assert_allclose(weights.numpy(), want / want.max(), rtol=1e-4)


def test_update_priorities():
    replay = PrioritizedReplay(size=4, importance_sampling_exponent=0.6)
    state = replay.init_state(torch.zeros(()))
    state, _ = replay.insert(state, torch.zeros((4,)), torch.ones((4,)))
    state = replay.update_priorities(state, torch.tensor([1, 3]),
                                     torch.tensor([5.0, 7.0]))
    assert state.priorities.tolist() == [1.0, 5.0, 1.0, 7.0]


def test_multi_axis_items_round_trip():
    replay = PrioritizedReplay(size=6, importance_sampling_exponent=0.5)
    item = {"frames": torch.zeros((5, 4, 3), dtype=torch.uint8),
            "r": torch.zeros((5,))}
    state = replay.init_state(item)
    assert state.buffer["frames"].shape == (6, 5, 4, 3)
    assert state.buffer["r"].shape == (6, 5)
    values = {
        "frames": torch.arange(2 * 60, dtype=torch.uint8).reshape(2, 5, 4, 3),
        "r": torch.ones((2, 5)),
    }
    state, _ = replay.insert(state, values, torch.ones((2,)))
    idx, _, items = replay.sample(state, _generator(0), 3, priority_exp=1.0)
    assert items["frames"].shape == (3, 5, 4, 3)
    assert items["r"].shape == (3, 5)
    for i, row in zip(idx.tolist(), items["frames"]):
        assert torch.equal(row, values["frames"][i])


def test_contract_checks_raise_only_when_enabled():
    replay = PrioritizedReplay(size=4, importance_sampling_exponent=0.6)
    state = replay.init_state(torch.zeros(()))
    bad = torch.tensor([1.0, float("nan")])
    calls = []
    debug_asserts.check(lambda: calls.append(1), "never evaluated")
    assert calls == []
    replay.insert(state, torch.zeros((2,)), bad)  # off: no check, no sync
    debug_asserts.enable()
    try:
        with pytest.raises(AssertionError, match="finite"):
            replay.insert(state, torch.zeros((2,)), bad)
        with pytest.raises(AssertionError, match="empty"):
            replay.sample(replay.init_state(torch.zeros(())), _generator(0),
                          2, priority_exp=1.0)
    finally:
        debug_asserts.enable(False)


class _IndexDtypes(TorchDispatchMode):
    """Records the dtype of every tensor operand of an ``aten.index*`` /
    ``index_put*`` / ``gather`` call made under it."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name.startswith("index") or name == "gather":
            for leaf in pytree.tree_leaves((args, kwargs or {})):
                if isinstance(leaf, torch.Tensor):
                    self.seen.add((name, leaf.dtype))
        return func(*args, **(kwargs or {}))


def _uint16_operands(mode):
    return sorted(name for name, dtype in mode.seen if dtype == torch.uint16)


def test_uint16_frames_are_gathered_through_their_signed_view():
    """C6: PyTorch has no CUDA index / index_put for uint16 (the synthetic
    Football env's packed frames), so every gather of such frames goes
    through the int16 view: the PPO minibatches and the device replay's
    sample. No uint16 operand reaches an indexing op, and what comes out
    is bit for bit the plain gather, top bit included."""
    from seed_rl_torch import distributions as tpd
    from seed_rl_torch import optim
    from seed_rl_torch.agent import PolicyAgent
    from seed_rl_torch.agents.ppo import learner as ppo
    from seed_rl_torch.agents.ppo import policy_losses
    from seed_rl_torch.agents.ppo.generalized_onpolicy_loss import (
        GeneralizedOnPolicyLoss,
    )
    from seed_rl_torch.envs import BatchedEnv
    from seed_rl_torch.envs.synthetic import SyntheticFootballEnv
    from seed_rl_torch.models import GFootball
    from seed_rl_torch.ops.advantages import GAE
    from seed_rl_torch.ops.popart import PopArt
    from seed_rl_torch.ops.running_statistics import AverageMeanStd
    from seed_rl_torch.rollout import RolloutEngine

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        env = BatchedEnv(SyntheticFootballEnv(episode_length=3), 4,
                         device="cpu")
        dist = tpd.get_parametric_distribution_for_action_space(
            env.action_space)
        net = GFootball(dist.param_size,
                        tuple(env.observation_spec().shape), device="cpu")
        agent = PolicyAgent(net, dist)
        loss = GeneralizedOnPolicyLoss(
            agent=agent,
            reward_normalizer=PopArt(AverageMeanStd(), compensate=False),
            parametric_action_distribution=dist,
            advantage_estimator=GAE(lambda_=0.95),
            policy_loss=policy_losses.ppo(epsilon=0.2), discount_factor=0.99)
        learner = ppo.PPOLearner(
            RolloutEngine(env, agent, 2, seed=1), agent, loss,
            ppo.PPOConfig(epochs_per_step=1, batch_mode="split",
                          batches_per_step=2),
            functools.partial(optim.ClippedAdam, learning_rate=1e-3,
                              clip_norm=40.0), seed=2)
        state = learner.init()
        with _IndexDtypes() as mode:
            state, logs = learner.train_step(state)
        assert all(np.isfinite(float(v)) for v in logs.values())
        assert _uint16_operands(mode) == []

        rng = np.random.RandomState(0)
        frames = rng.randint(0, 2 ** 16, (6, 5, 4, 1)).astype(np.uint16)
        frames[0, 0, 0, 0], frames[3, 1, 2, 0] = 0xFFFF, 0x8000
        columns = torch.from_numpy(frames[:, None].repeat(3, axis=1))
        batch = ppo._Batch(agent_state=(), prev_actions=torch.zeros((3, 6)),
                           env_outputs={"f": columns.transpose(0, 1)},
                           agent_outputs=())
        idx = torch.tensor([5, 0, 3, 3])
        with _IndexDtypes() as mode:
            taken = batch.take(idx)
        assert _uint16_operands(mode) == []
        np.testing.assert_array_equal(
            taken.env_outputs["f"].numpy(), frames[None, [5, 0, 3, 3]].repeat(
                3, axis=0))
        assert taken.env_outputs["f"].dtype == torch.uint16

        replay = PrioritizedReplay(size=8, importance_sampling_exponent=0.6)
        with _IndexDtypes() as mode:
            rstate = replay.init_state({"f": torch.from_numpy(frames[0])})
            rstate, _ = replay.insert(rstate, {"f": torch.from_numpy(frames)},
                                      torch.arange(1.0, 7.0))
            indices, _, items = replay.sample(rstate, _generator(0), 16,
                                              priority_exp=0.9)
        assert _uint16_operands(mode) == []
        assert items["f"].dtype == torch.uint16
        np.testing.assert_array_equal(items["f"].numpy(),
                                      frames[indices.numpy()])
    finally:
        torch.set_num_threads(threads)
