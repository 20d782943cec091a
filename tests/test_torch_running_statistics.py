"""Running statistics, PopArt and input normalization in seed_rl_torch
against the JAX package.

Every tracker (``EMAMeanStd``, ``AverageMeanStd`` with ``merge`` and
``reset``, ``FixedMeanStd``, ``TwoLevelAverageMeanStd``) folds the same
seeded batches as the JAX one; states and (mean, std) agree within rtol
1e-5 / atol 1e-6 (float32 sums in another order). ``PopArt`` with and
without compensation and ``InputNormalization`` agree with JAX on their
updates and their outputs, and keep the prediction invariant under a
statistics update (mirroring tests/test_running_statistics.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seed_rl_tpu.agents.ppo import input_normalization as jax_in
from seed_rl_tpu.ops import popart as jax_popart
from seed_rl_tpu.ops import running_statistics as jrs
from seed_rl_torch.agents.ppo.input_normalization import InputNormalization
from seed_rl_torch.ops import running_statistics as rs
from seed_rl_torch.ops.popart import PopArt

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, want, tol=TOL):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


def _batches(seed, shape, n=5):
    rng = np.random.RandomState(seed)
    return [(rng.normal(size=shape) * (i + 1) + i).astype(np.float32)
            for i in range(n)]


TRACKERS = {
    "ema": (lambda: rs.EMAMeanStd(beta=0.3),
            lambda: jrs.EMAMeanStd(beta=0.3)),
    "average": (rs.AverageMeanStd, jrs.AverageMeanStd),
    "fixed": (lambda: rs.FixedMeanStd(2.0, 4.0),
              lambda: jrs.FixedMeanStd(2.0, 4.0)),
    "two_level": (lambda: rs.TwoLevelAverageMeanStd(buffer_size=2),
                  lambda: jrs.TwoLevelAverageMeanStd(buffer_size=2)),
}


@pytest.mark.parametrize("kind", sorted(TRACKERS))
def test_tracker_matches_jax(kind):
    tracker, jtracker = (make() for make in TRACKERS[kind])
    state, jstate = tracker.init_state(3, "cpu"), jtracker.init_state(3)
    _close(tracker.mean_std(state), jtracker.mean_std(jstate))
    for batch in _batches(0, (4, 5, 3)):
        state = tracker.update(state, torch.from_numpy(batch))
        jstate = jtracker.update(jstate, jnp.asarray(batch))
        _close(state, jstate)
        _close(tracker.mean_std(state), jtracker.mean_std(jstate))
    x = _batches(1, (6, 3), 1)[0]
    _close(tracker.normalize(state, torch.from_numpy(x)),
           jtracker.normalize(jstate, jnp.asarray(x)))
    _close(tracker.unnormalize(state, torch.from_numpy(x)),
           jtracker.unnormalize(jstate, jnp.asarray(x)))


def test_average_mean_std_matches_numpy_and_starts_at_unit_std():
    tracker = rs.AverageMeanStd()
    state = tracker.init_state(3)
    mean, std = tracker.mean_std(state)
    torch.testing.assert_close(mean, torch.zeros(3))
    torch.testing.assert_close(std, torch.ones(3))
    chunks = _batches(2, (5, 4, 3), 4)
    for c in chunks:
        state = tracker.update(state, torch.from_numpy(c))
    flat = np.concatenate([c.reshape(-1, 3) for c in chunks])
    mean, std = tracker.mean_std(state)
    np.testing.assert_allclose(mean.numpy(), flat.mean(0), rtol=1e-4)
    np.testing.assert_allclose(std.numpy(), flat.std(0), rtol=1e-3)
    assert state.update_count.dtype == torch.int32
    assert int(state.update_count) == 4


@pytest.mark.parametrize("alpha", [0.0, 1.0, 0.25])
def test_average_merge_and_reset_match_jax(alpha):
    tracker, jtracker = rs.AverageMeanStd(), jrs.AverageMeanStd()
    a, b = (tracker.init_state(2) for _ in range(2))
    ja, jb = (jtracker.init_state(2) for _ in range(2))
    for x, y in zip(_batches(3, (7, 2), 3), _batches(4, (5, 2), 3)):
        a, ja = tracker.update(a, torch.from_numpy(x)), jtracker.update(ja, x)
        b, jb = tracker.update(b, torch.from_numpy(y)), jtracker.update(jb, y)
    _close(tracker.merge(a, b, torch.tensor(alpha)),
           jtracker.merge(ja, jb, jnp.float32(alpha)))
    _close(tracker.reset(a, torch.tensor(alpha)),
           jtracker.reset(ja, jnp.float32(alpha)))


def test_two_level_matches_single_level_and_starts_at_unit_std():
    single, double = rs.AverageMeanStd(), rs.TwoLevelAverageMeanStd(
        buffer_size=3)
    s1, s2 = single.init_state(2), double.init_state(2)
    mean, std = double.mean_std(s2)
    torch.testing.assert_close(mean, torch.zeros(2))
    torch.testing.assert_close(std, torch.ones(2))
    for data in _batches(5, (6, 2), 10):
        s1 = single.update(s1, torch.from_numpy(data))
        s2 = double.update(s2, torch.from_numpy(data))
    for a, b in zip(single.mean_std(s1), double.mean_std(s2)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=0)


@pytest.mark.parametrize("compensate", [True, False])
def test_popart_matches_jax_and_keeps_the_prediction(compensate):
    popart = PopArt(rs.AverageMeanStd(), compensate=compensate)
    jpop = jax_popart.PopArt(jrs.AverageMeanStd(), compensate=compensate)
    state, jstate = popart.init_state(), jpop.init_state()
    params, jparams = popart.init_params(), jpop.init_params()
    _close(params, jparams)
    rng = np.random.RandomState(6)
    x = rng.normal(size=(7,)).astype(np.float32)

    def implicit(state, params):
        return popart.unnormalize_prediction(
            state, popart.correct_prediction(params, torch.from_numpy(x)))

    for _ in range(3):
        data = (rng.normal(size=(4, 5)) * 10 + 3).astype(np.float32)
        before = implicit(state, params)
        state, params, logs = popart.update_statistics(
            state, params, torch.from_numpy(data))
        jstate, jparams, jlogs = jpop.update_statistics(
            jstate, jparams, jnp.asarray(data))
        _close(state, jstate)
        _close(params, jparams)
        _close(logs, jlogs)
        if compensate:
            torch.testing.assert_close(implicit(state, params), before,
                                       rtol=1e-4, atol=1e-4)
    targets = rng.normal(size=(3, 4)).astype(np.float32)
    for fn in ("normalize_target", "normalize_advantage",
               "unnormalize_prediction"):
        _close(getattr(popart, fn)(state, torch.from_numpy(targets)),
               getattr(jpop, fn)(jstate, jnp.asarray(targets)))
    _close(popart.correct_prediction(params, torch.from_numpy(targets)),
           jpop.correct_prediction(jparams, jnp.asarray(targets)))


def test_popart_normalize_advantage_divides_by_std():
    popart = PopArt(rs.FixedMeanStd(mean=5.0, std=2.0))
    state = popart.init_state()
    assert float(popart.normalize_advantage(state, torch.tensor([4.0]))) == 2
    assert float(popart.normalize_target(state, torch.tensor([9.0]))) == 2


def test_input_normalization_matches_jax_and_is_invariant():
    norm = InputNormalization(rs.AverageMeanStd(), input_size=3)
    jnorm = jax_in.InputNormalization(jrs.AverageMeanStd(), input_size=3)
    state, params = norm.init_state(), norm.init_params()
    jstate, jparams = jnorm.init_state(), jnorm.init_params()
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))

    def out(state, params):
        return norm.correct(params, norm.normalize(state, x))

    for _ in range(3):
        before = out(state, params)
        data = (rng.normal(size=(20, 3)) * 4 - 2).astype(np.float32)
        state, params = norm.update_statistics(state, params,
                                               torch.from_numpy(data))
        jstate, jparams = jnorm.update_statistics(jstate, jparams,
                                                  jnp.asarray(data))
        _close(state, jstate)
        _close(params, jparams)
        torch.testing.assert_close(out(state, params), before, rtol=1e-4,
                                   atol=1e-4)
    _close(norm.mean_std(state), jnorm.mean_std(jstate))
