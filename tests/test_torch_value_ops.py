"""The port's R2D2 value ops (seed_rl_torch.ops.value_ops) against JAX.

The same numpy inputs go through ``seed_rl_tpu.ops.value_ops``, the JAX
package's Pallas n-step kernel in interpret mode, the port's plain version
and the port's kernel wrapper on CPU tensors (which must take the plain
version). Losses, priorities and targets agree within rtol = atol = 1e-5
(float32; see CASES for the one pair left out); the gradient of the
summed loss in the Q values within rtol 1e-3 / atol 1e-4, as
tests/test_pallas_nstep.py states for sum-order wiggle. The value-op cases
mirror tests/test_value_ops.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seed_rl_tpu.ops import value_ops as jvo
from seed_rl_tpu.ops.pallas import nstep_kernel as jax_kernel
from seed_rl_torch.ops import value_ops
from seed_rl_torch.ops.cuda import nstep_kernel, run_count

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def _random_inputs(rng, T, B, A, done_p=0.1):
    return dict(
        q_values=rng.normal(size=(T, B, A)).astype(np.float32),
        target_q_values=rng.normal(size=(T, B, A)).astype(np.float32),
        online_argmax_action=rng.randint(0, A, (T, B)).astype(np.int32),
        replay_action=rng.randint(0, A, (T, B)).astype(np.int32),
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        done=rng.binomial(1, done_p, (T, B)).astype(bool),
    )


def _torch(kwargs):
    return {k: torch.from_numpy(np.array(v)) for k, v in kwargs.items()}


# (seed, T, B, A, gamma, n_steps, eta): the three tests/test_pallas_nstep.py
# cases with their seeds, n >= T with an odd B, T = 2, and the R2D2 loss
# shape of chip_smoke.py. The port's plain version does the lax version's
# arithmetic in its order and matches it to an ulp or two. The Pallas
# kernel orders it differently, and h^-1 squares a difference that cancels
# to ~1e-3, so the two JAX versions part by up to ~3e-5 (relative) on the
# loss of "gradient-case", which tests/test_pallas_nstep.py compares on the
# gradient only; so does this file.
CASES = {
    "aligned": (0, 11, 256, 6, 0.997, 5, 0.9),
    "small-batch": (1, 7, 64, 4, 0.99, 3, 0.7),
    "gradient-case": (2, 6, 128, 3, 0.99, 2, 0.9),
    "n-exceeds-T": (3, 3, 37, 4, 0.997, 5, 0.9),
    "T2": (4, 2, 1, 4, 0.997, 1, 0.9),
    "r2d2-loss-shape": (5, 81, 64, 4, 0.997, 5, 0.9),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_td_loss_and_priorities_match_jax(case):
    seed, T, B, A, gamma, n, eta = CASES[case]
    kwargs = _random_inputs(np.random.RandomState(seed), T, B, A,
                            done_p=0.3 if T <= 3 else 0.1)
    kw = dict(gamma=gamma, n_steps=n, eta=eta)
    want_loss, want_pri = jvo.td_loss_and_priorities(**kwargs, **kw)
    pallas_loss, pallas_pri = jax_kernel.td_loss_and_priorities(
        **kwargs, **kw, interpret=True)
    for fn in (value_ops.td_loss_and_priorities,
               nstep_kernel.td_loss_and_priorities,
               nstep_kernel.td_loss_and_priorities_dispatch):
        loss, pri = fn(**_torch(kwargs), **kw)
        assert loss.shape == pri.shape == (B,)
        pairs = [(loss, want_loss), (pri, want_pri)]
        if case != "gradient-case":
            pairs += [(loss, pallas_loss), (pri, pallas_pri)]
        for got, want in pairs:
            np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("case", ["gradient-case", "small-batch"])
def test_td_loss_gradient_matches_jax(case):
    seed, T, B, A, gamma, n, eta = CASES[case]
    kwargs = _random_inputs(np.random.RandomState(seed), T, B, A)
    q = kwargs.pop("q_values")
    kw = dict(gamma=gamma, n_steps=n, eta=eta)

    def jax_loss(q_values):
        loss, _ = jvo.td_loss_and_priorities(q_values, **kwargs, **kw)
        return loss.sum()

    def pallas_loss(q_values):
        loss, _ = jax_kernel.td_loss_and_priorities(
            q_values, **kwargs, **kw, interpret=True)
        return loss.sum()

    want = jax.grad(jax_loss)(jnp.asarray(q))
    want_pallas = jax.grad(pallas_loss)(jnp.asarray(q))
    for fn in (value_ops.td_loss_and_priorities,
               nstep_kernel.td_loss_and_priorities):
        q_t = torch.from_numpy(q.copy()).requires_grad_(True)
        loss, pri = fn(q_t, **_torch(kwargs), **kw)
        assert not pri.requires_grad
        (grad,) = torch.autograd.grad(loss.sum(), q_t)
        np.testing.assert_allclose(grad.numpy(), want, **GRAD_TOL)
        np.testing.assert_allclose(grad.numpy(), want_pallas, **GRAD_TOL)


@pytest.mark.parametrize("n_steps", [1, 2, 3, 5, 9])
def test_n_step_bellman_target_matches_jax(n_steps):
    rng = np.random.RandomState(n_steps)
    T, B = 8, 3
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    done = rng.binomial(1, 0.2, (T, B)).astype(bool)
    q_target = rng.normal(size=(T, B)).astype(np.float32)
    want = jvo.n_step_bellman_target(rewards, done, q_target, 0.95, n_steps)
    got = value_ops.n_step_bellman_target(
        torch.from_numpy(rewards), torch.from_numpy(done),
        torch.from_numpy(q_target), 0.95, n_steps)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_n_step_bellman_target_hand_computed():
    # T=3, B=1, gamma=0.5, n=2, no dones (tests/test_value_ops.py).
    got = value_ops.n_step_bellman_target(
        torch.tensor([[1.0], [2.0], [3.0]]), torch.zeros((3, 1), dtype=bool),
        torch.tensor([[10.0], [20.0], [30.0]]), 0.5, 2)
    np.testing.assert_allclose(got[:, 0].numpy(), [7.0, 11.0, 18.0],
                               rtol=1e-5)


def test_rescaling_matches_jax_and_round_trips():
    x = np.linspace(-500.0, 500.0, 2001).astype(np.float32)
    xt = torch.from_numpy(x)
    h = value_ops.value_function_rescaling(xt)
    np.testing.assert_allclose(
        h.numpy(), jvo.value_function_rescaling(x), **TOL)
    np.testing.assert_allclose(
        value_ops.inverse_value_function_rescaling(xt).numpy(),
        jvo.inverse_value_function_rescaling(x), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        value_ops.inverse_value_function_rescaling(h).numpy(), x,
        rtol=2e-3, atol=2e-3)
    zero = torch.tensor(0.0)
    assert float(value_ops.value_function_rescaling(zero)) == 0.0
    assert float(value_ops.inverse_value_function_rescaling(zero)) == 0.0


def _retrace_inputs(seed, T=9, B=5):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    done = rng.random((T, B)) < 0.2
    q_max = rng.normal(size=(T, B)).astype(np.float32)
    q_rep = q_max - np.abs(rng.normal(size=(T, B))).astype(np.float32)
    trace = (0.95 * (rng.random((T, B)) < 0.7)).astype(np.float32)
    return rewards, done, q_max, q_rep, trace


def test_retrace_target_matches_jax():
    inputs = _retrace_inputs(0)
    want = jvo.retrace_target(*inputs, gamma=0.97)
    got = value_ops.retrace_target(
        *map(torch.from_numpy, inputs), gamma=0.97)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_retrace_loss_and_priorities_match_jax():
    rng = np.random.RandomState(5)
    kwargs = _random_inputs(rng, 7, 3, 5, done_p=0.2)
    want_loss, want_pri = jvo.retrace_loss_and_priorities(
        **kwargs, gamma=0.95, lambda_=0.9, eta=0.8)
    q = torch.from_numpy(kwargs.pop("q_values")).requires_grad_(True)
    loss, pri = value_ops.retrace_loss_and_priorities(
        q, **_torch(kwargs), gamma=0.95, lambda_=0.9, eta=0.8)
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, **TOL)
    np.testing.assert_allclose(pri.numpy(), want_pri, **TOL)
    assert loss.requires_grad and not pri.requires_grad


def test_retrace_reduces_to_n_step_when_on_policy():
    """lambda = 1 and greedy replayed actions: Retrace telescopes to the
    full-sequence n-step target (tests/test_value_ops.py)."""
    rng = np.random.default_rng(2)
    T, B, A = 7, 3, 5
    q = torch.from_numpy(rng.normal(size=(T, B, A)).astype(np.float32))
    tq = torch.from_numpy(rng.normal(size=(T, B, A)).astype(np.float32))
    greedy = torch.argmax(tq, dim=-1).to(torch.int32)
    rewards = torch.from_numpy(rng.normal(size=(T, B)).astype(np.float32))
    done = torch.from_numpy(rng.random((T, B)) < 0.2)
    loss_r, pri_r = value_ops.retrace_loss_and_priorities(
        q, tq, greedy, greedy, rewards, done, gamma=0.95, lambda_=1.0)
    loss_n, pri_n = value_ops.td_loss_and_priorities(
        q, tq, greedy, greedy, rewards, done, gamma=0.95, n_steps=T)
    torch.testing.assert_close(loss_r, loss_n, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(pri_r, pri_n, rtol=1e-4, atol=1e-4)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    kwargs = _torch(_random_inputs(np.random.RandomState(0), 4, 8, 3))
    kw = dict(gamma=0.99, n_steps=2)
    short = {k: v[:1] for k, v in kwargs.items()}
    with pytest.raises(ValueError, match="T >= 2"):
        nstep_kernel.td_loss_and_priorities(**short, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        strided = dict(kwargs, rewards=kwargs["rewards"].t().contiguous().t())
        nstep_kernel.td_loss_and_priorities(**strided, **kw)
    with pytest.raises(TypeError):
        nstep_kernel.td_loss_and_priorities(
            **dict(kwargs, rewards=kwargs["rewards"].to(torch.int32)), **kw)
    with pytest.raises(TypeError):
        nstep_kernel.td_loss_and_priorities(
            **dict(kwargs, replay_action=kwargs["rewards"]), **kw)
    with pytest.raises(ValueError):
        nstep_kernel.td_loss_and_priorities(
            **dict(kwargs, done=kwargs["done"][:, :3]), **kw)
    with pytest.raises(ValueError, match="n_steps"):
        nstep_kernel.td_loss_and_priorities(**kwargs, gamma=0.99, n_steps=0)
    before = run_count.read(nstep_kernel.KERNEL_NAME)
    nstep_kernel.td_loss_and_priorities(**kwargs, **kw)
    # The plain path counts no run.
    assert run_count.read(nstep_kernel.KERNEL_NAME) == before
