"""The port's plain V-trace (seed_rl_torch.ops.vtrace) against the JAX package.

Same inputs, made from a seed with numpy, go through the JAX lax.scan
version, the Pallas kernel in interpret mode (where B % 128 == 0, as the
TPU kernel requires), and the port; they agree within rtol = atol = 1e-5.
The analytic cases mirror tests/test_vtrace.py. The CUDA kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from seed_rl_tpu.ops import vtrace as jax_vtrace
from seed_rl_tpu.ops.pallas import vtrace_kernel as jax_pallas
from seed_rl_torch.ops import vtrace as torch_vtrace
from seed_rl_torch.ops.cuda import run_count, vtrace_kernel

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(T, B, seed):
    rng = np.random.RandomState(seed)
    return dict(
        target_action_log_probs=rng.uniform(-1, 1, (T, B)).astype(np.float32),
        behaviour_action_log_probs=rng.uniform(-1, 1, (T, B)).astype(
            np.float32
        ),
        discounts=(rng.binomial(1, 0.9, (T, B)) * 0.99).astype(np.float32),
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        values=rng.normal(size=(T, B)).astype(np.float32),
        bootstrap_value=rng.normal(size=(B,)).astype(np.float32),
    )


def _torch(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


# (T, B, lambda_, clip_rho_threshold, clip_pg_rho_threshold)
CASES = [
    (12, 256, 0.95, 1.0, 1.0),  # tests/test_pallas_vtrace.py
    (5, 128, 1.0, None, None),  # its no-clip case
    (7, 37, 1.0, 1.0, 1.0),  # an odd B
    (1, 128, 1.0, 1.0, 1.0),  # T = 1
    (1, 5, 0.9, 2.0, 0.5),  # T = 1, odd B, distinct clips
    (32, 64, 1.0, 1.0, 1.0),  # the main path's T
]


@pytest.mark.parametrize("T,B,lam,clip_rho,clip_pg", CASES)
def test_plain_matches_jax_scan_and_pallas(T, B, lam, clip_rho, clip_pg):
    inputs = _inputs(T, B, seed=T * 1000 + B)
    kwargs = dict(
        clip_rho_threshold=clip_rho, clip_pg_rho_threshold=clip_pg,
        lambda_=lam,
    )
    got = torch_vtrace.from_importance_weights(**_torch(inputs), **kwargs)
    wants = [jax_vtrace.from_importance_weights(**inputs, **kwargs)]
    if B % jax_pallas.TILE_B == 0:
        wants.append(
            jax_pallas.from_importance_weights_pallas(
                **inputs, **kwargs, interpret=True
            )
        )
    for want in wants:
        np.testing.assert_allclose(got.vs.numpy(), want.vs, **TOL)
        np.testing.assert_allclose(
            got.pg_advantages.numpy(), want.pg_advantages, **TOL
        )


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("lambda_", [1.0, 0.9])
def test_matches_jax_on_test_vtrace_inputs(seed, lambda_):
    # tests/test_vtrace.py::test_vtrace_matches_numpy's inputs.
    rng = np.random.RandomState(seed)
    T, B = 5, 4
    log_rhos = rng.uniform(-2, 2, (T, B)).astype(np.float32)
    discounts = rng.binomial(1, 0.9, (T, B)).astype(np.float32) * 0.95
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    bootstrap = rng.normal(size=(B,)).astype(np.float32)
    args = [log_rhos, np.zeros_like(log_rhos), discounts, rewards, values,
            bootstrap]
    got = torch_vtrace.from_importance_weights(
        *map(torch.from_numpy, args), lambda_=lambda_
    )
    want = jax_vtrace.from_importance_weights(*args, lambda_=lambda_)
    np.testing.assert_allclose(got.vs.numpy(), want.vs, **TOL)
    np.testing.assert_allclose(
        got.pg_advantages.numpy(), want.pg_advantages, **TOL
    )


def test_on_policy_equals_lambda_returns():
    # With rho == 1 and lambda == 1, vs are the on-policy discounted returns.
    T, B = 4, 2
    rng = np.random.RandomState(3)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    bootstrap = rng.normal(size=(B,)).astype(np.float32)
    discounts = np.full((T, B), 0.9, np.float32)
    got = torch_vtrace.from_importance_weights(
        torch.zeros(T, B), torch.zeros(T, B), torch.from_numpy(discounts),
        torch.from_numpy(rewards), torch.from_numpy(values),
        torch.from_numpy(bootstrap),
    )
    expected = np.zeros((T, B), np.float32)
    acc = bootstrap.copy()
    for t in reversed(range(T)):
        acc = rewards[t] + discounts[t] * acc
        expected[t] = acc
    np.testing.assert_allclose(got.vs.numpy(), expected, rtol=1e-4, atol=1e-4)


def test_gradients_stopped():
    T, B = 3, 2
    values = torch.ones(T, B, requires_grad=True)
    target = torch.zeros(T, B, requires_grad=True)
    out = vtrace_kernel.from_importance_weights(
        target, torch.zeros(T, B), torch.full((T, B), 0.9),
        torch.ones(T, B), values, torch.ones(B),
    )
    assert not out.vs.requires_grad
    assert not out.pg_advantages.requires_grad


def test_wrapper_takes_plain_version_on_cpu():
    inputs = _torch(_inputs(6, 33, seed=5))
    before = run_count.read(vtrace_kernel.KERNEL_NAME)
    got = vtrace_kernel.from_importance_weights(**inputs, lambda_=0.95)
    want = torch_vtrace.from_importance_weights(**inputs, lambda_=0.95)
    # The plain path counts no run.
    assert run_count.read(vtrace_kernel.KERNEL_NAME) == before
    torch.testing.assert_close(got.vs, want.vs, rtol=0, atol=0)
    torch.testing.assert_close(
        got.pg_advantages, want.pg_advantages, rtol=0, atol=0
    )


def test_wrapper_refuses_non_cuda_non_cpu_tensors():
    inputs = {k: v.to("meta") for k, v in _torch(_inputs(3, 8, 0)).items()}
    with pytest.raises(ValueError, match="CUDA"):
        vtrace_kernel.from_importance_weights(**inputs)


def test_jax_dispatch_agrees_with_port_at_odd_shape():
    # The JAX dispatch takes the scan off the TPU; the port takes its plain
    # version on the CPU: both at a shape the TPU kernel refuses.
    inputs = _inputs(9, 50, seed=9)
    want = jax_pallas.from_importance_weights(
        *[jnp.asarray(v) for v in inputs.values()]
    )
    got = vtrace_kernel.from_importance_weights(**_torch(inputs))
    np.testing.assert_allclose(got.vs.numpy(), want.vs, **TOL)
    np.testing.assert_allclose(
        got.pg_advantages.numpy(), want.pg_advantages, **TOL
    )
