"""The port's prioritized replay (seed_rl_torch.replay) against JAX.

Mirrors the prioritized cases of tests/test_replay.py (FIFO wrap-around,
priority-respecting sampling, uniform sampling at exponent 0, the
importance-weight formula, priority updates, multi-axis items), and holds
the importance weights against ``seed_rl_tpu.replay`` on the same buffer
with JAX's draw injected as the indices (rtol 1e-5: float32, one rounding
of 1/limit apart). The contract checks raise only with debug asserts on.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

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
