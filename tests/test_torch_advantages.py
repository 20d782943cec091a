"""The abandoned-aware advantage estimators of seed_rl_torch against the
JAX package and against naive recursions (mirroring
tests/test_advantages.py).

``vtrace``, ``gae`` and ``n_step`` take the same seeded inputs, with
terminated and abandoned steps, as ``seed_rl_tpu.ops.advantages``; targets
and advantages agree within rtol 1e-5 / atol 1e-6 (float32, the same
recursion order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from seed_rl_tpu.ops import advantages as jadv
from seed_rl_torch.ops import advantages

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed, T=7, B=5):
    rng = np.random.RandomState(seed)
    term = rng.binomial(1, 0.2, (T, B)).astype(bool)
    return dict(
        values=rng.normal(size=(T + 1, B)).astype(np.float32),
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        done_terminated=term,
        done_abandoned=rng.binomial(1, 0.15, (T, B)).astype(bool) & ~term,
        target_action_log_probs=rng.uniform(-1, 1, (T, B)).astype(np.float32),
        behaviour_action_log_probs=rng.uniform(-1, 1, (T, B)).astype(
            np.float32),
    )


def _torch(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


def _check(got, want):
    for g, w in zip(got, want):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("estimator", [
    lambda m: (m.VTrace(0.9, max_importance_weight=1.5), 0.95),
    lambda m: (m.VTrace(1.0), 0.99),
    lambda m: (m.GAE(0.95), 0.97),
    lambda m: (m.NStep(3), 0.9),
    lambda m: (m.NStep(20), 0.9),
], ids=["vtrace-0.9-clip1.5", "vtrace", "gae", "nstep-3", "nstep-past-T"])
def test_estimators_match_jax(seed, estimator):
    inputs = _inputs(seed)
    ours, gamma = estimator(advantages)
    theirs, _ = estimator(jadv)
    args = ("values", "rewards", "done_terminated", "done_abandoned")
    logp = ("target_action_log_probs", "behaviour_action_log_probs")
    t = _torch(inputs)
    got = ours(*(t[k] for k in args), gamma, *(t[k] for k in logp))
    want = theirs(*(jnp.asarray(inputs[k]) for k in args), gamma,
                  *(jnp.asarray(inputs[k]) for k in logp))
    _check(got, want)


def _naive_vtrace(values, rewards, done_term, done_aband, gamma, t_logp,
                  b_logp, lambda_=1.0, max_iw=1.0):
    T, B = rewards.shape
    rhos = np.minimum(np.exp(t_logp - b_logp), max_iw)
    not_term = (~done_term).astype(np.float64)
    not_aband = (~done_aband).astype(np.float64)
    deltas = (rewards + gamma * not_term * values[1:] - values[:-1]) * not_aband
    propagate = not_term * not_aband
    acc = np.zeros(B)
    targets, advs = np.zeros((T, B)), np.zeros((T, B))
    for i in range(T - 1, -1, -1):
        advs[i] = deltas[i] + propagate[i] * gamma * lambda_ * acc
        acc = rhos[i] * advs[i]
        targets[i] = values[i] + acc
    return targets, advs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vtrace_matches_naive(seed):
    inputs = _inputs(seed)
    args = [inputs[k] for k in ("values", "rewards", "done_terminated",
                                "done_abandoned")]
    logp = [inputs["target_action_log_probs"],
            inputs["behaviour_action_log_probs"]]
    got = advantages.vtrace(*map(torch.from_numpy, args), 0.95,
                            *map(torch.from_numpy, logp), lambda_=0.9,
                            max_importance_weight=1.5)
    want = _naive_vtrace(*args, 0.95, *logp, lambda_=0.9, max_iw=1.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-3)


def test_abandoned_step_has_zero_advantage_and_value_target():
    T = 4
    values = torch.arange(T + 1, dtype=torch.float32)[:, None] + 1.0
    done_aband = torch.zeros((T, 1), dtype=torch.bool)
    done_aband[2] = True
    targets, advs = advantages.gae(values, torch.ones((T, 1)),
                                   torch.zeros_like(done_aband), done_aband,
                                   0.9, lambda_=1.0)
    assert float(advs[2, 0]) == 0.0
    assert float(targets[2, 0]) == float(values[2, 0])


def test_terminated_step_bootstraps_zero():
    targets, advs = advantages.gae(
        torch.tensor([[5.0], [100.0]]), torch.tensor([[2.0]]),
        torch.tensor([[True]]), torch.tensor([[False]]), 0.9)
    assert float(targets[0, 0]) == 2.0  # the post-reset value is ignored
    assert float(advs[0, 0]) == 2.0 - 5.0


def test_gae_matches_the_classic_formula_without_dones():
    rng = np.random.RandomState(1)
    T, B, gamma, lam = 5, 2, 0.99, 0.95
    values = rng.normal(size=(T + 1, B)).astype(np.float32)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    dones = torch.zeros((T, B), dtype=torch.bool)
    _, advs = advantages.gae(torch.from_numpy(values),
                             torch.from_numpy(rewards), dones, dones, gamma,
                             lambda_=lam)
    deltas = rewards + gamma * values[1:] - values[:-1]
    expected = np.zeros((T, B))
    for t in range(T):
        for k in range(T - t):
            expected[t] += (gamma * lam) ** k * deltas[t + k]
    np.testing.assert_allclose(advs.numpy(), expected, rtol=1e-4, atol=1e-4)


def test_n_step_edge_cases():
    no = torch.zeros((3, 1), dtype=torch.bool)
    values = torch.tensor([[1.0], [2.0], [3.0], [4.0]])
    rewards = torch.ones((3, 1))
    targets, _ = advantages.n_step(values, rewards, no, no, 0.5, n=10)
    # n >= T: the full discounted return to values[T]; the last step falls
    # back to one step through the abandon padding.
    assert float(targets[0, 0]) == pytest.approx(1 + 0.5 + 0.25 + 0.5**3 * 4)
    assert float(targets[2, 0]) == pytest.approx(1 + 0.5 * 4)
    # Termination at step 1 zeroes the bootstrap of step 0's return.
    term = torch.tensor([[False], [True], [False]])
    targets, _ = advantages.n_step(torch.full((4, 1), 50.0), rewards, term,
                                   no, 0.9, n=3)
    assert float(targets[0, 0]) == pytest.approx(1 + 0.9 * 1.0)
    # n = 1 is the TD target.
    targets, advs = advantages.n_step(values, rewards, no, no, 0.9, n=1)
    torch.testing.assert_close(targets, rewards + 0.9 * values[1:])
    torch.testing.assert_close(advs, targets - values[:-1])
