"""seed_rl_torch.ops.pooling.max_pool_same against the JAX package's pool.

Mirrors tests/test_pooling.py: the port's forward must equal both JAX
settings of the ResNet pool, ``ops.pooling.max_pool_same`` (the dense
custom backward) and ``flax.linen.max_pool(..., "SAME")`` (XLA's
SelectAndScatter backward), exactly; its backward must equal both, ties
included. An input that wins several windows sums their cotangents in
another order than JAX does, so backward values agree within 1e-6 (as
tests/test_pooling.py holds the two JAX versions to each other); where
every window is a tie the routing alone decides, and the gradients must be
equal. Inputs are NHWC for JAX and the same data as NCHW for the port.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_rl_tpu.ops.pooling import max_pool_same as jax_max_pool_same
from seed_rl_torch.ops.pooling import max_pool_same

BWD_TOL = dict(rtol=1e-6, atol=1e-6)


def _flax_pool(x, window=(3, 3), strides=(2, 2)):
    return nn.max_pool(x, window, strides=strides, padding="SAME")


# Both JAX settings of ResidualStack's pool (custom_pool_bwd True / False).
JAX_POOLS = {"custom": jax_max_pool_same, "flax": _flax_pool}

SHAPES = [
    (3, 72, 96, 4),   # DmLab stack0 (even dims, asymmetric pad)
    (2, 36, 48, 8),
    (2, 9, 12, 3),    # odd dims
    (1, 5, 5, 1),
    # The three pools on ImpalaDeep's 84x84 path: pads (0, 1), (0, 1), (1, 1).
    (2, 84, 84, 2),
    (2, 42, 42, 3),
    (2, 21, 21, 3),
]


def _forward_and_grad(x_nhwc, ct_nhwc, window=(3, 3), strides=(2, 2)):
    """The port's pool and gradient on NHWC numpy data, returned as NHWC."""
    x = torch.tensor(np.asarray(x_nhwc)).permute(0, 3, 1, 2)
    x.requires_grad_(True)
    out = max_pool_same(x, window, strides)
    ct = torch.tensor(np.asarray(ct_nhwc)).permute(0, 3, 1, 2)
    (grad,) = torch.autograd.grad(out, x, ct)
    return (out.detach().permute(0, 2, 3, 1).numpy(),
            grad.permute(0, 2, 3, 1).numpy())


def _jax_forward_and_grad(pool, x, ct):
    out, vjp = jax.vjp(pool, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(ct))[0])


def _cotangent(rng, x, pool=_flax_pool):
    return rng.normal(size=jax.eval_shape(pool, jnp.asarray(x)).shape).astype(
        np.float32)


@pytest.mark.parametrize("pool", sorted(JAX_POOLS))
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_backward_match_jax(shape, pool):
    rng = np.random.RandomState(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    ct = _cotangent(rng, x)
    want_out, want_grad = _jax_forward_and_grad(JAX_POOLS[pool], x, ct)
    out, grad = _forward_and_grad(x, ct)
    np.testing.assert_array_equal(out, want_out)
    np.testing.assert_allclose(grad, want_grad, **BWD_TOL)


@pytest.mark.parametrize("pool", sorted(JAX_POOLS))
def test_backward_tie_breaking_matches(pool):
    # Constant inputs: every window is all ties, so the first maximum in
    # row-major window order takes the cotangent, element for element.
    rng = np.random.RandomState(3)
    for shape in [(1, 6, 6, 1), (1, 7, 9, 2), (2, 72, 96, 3), (1, 84, 84, 2),
                  (1, 21, 21, 2)]:
        x = np.ones(shape, np.float32)
        ct = _cotangent(rng, x) + 2.0
        _, want_grad = _jax_forward_and_grad(JAX_POOLS[pool], x, ct)
        _, grad = _forward_and_grad(x, ct)
        np.testing.assert_array_equal(grad, want_grad)


@pytest.mark.parametrize("pool", sorted(JAX_POOLS))
def test_quantized_random_ties(pool):
    # Coarsely quantized data: many partial ties inside windows. Cotangents
    # on a 1/8 grid sum exactly in any order, so routing alone is compared.
    rng = np.random.RandomState(4)
    x = (np.round(rng.normal(size=(4, 36, 48, 8)) * 2) / 2).astype(np.float32)
    ct = (np.round(_cotangent(rng, x) * 8) / 8).astype(np.float32)
    want_out, want_grad = _jax_forward_and_grad(JAX_POOLS[pool], x, ct)
    out, grad = _forward_and_grad(x, ct)
    np.testing.assert_array_equal(out, want_out)
    np.testing.assert_array_equal(grad, want_grad)


def test_window_2x2_stride_2():
    rng = np.random.RandomState(8)
    x = rng.normal(size=(2, 10, 10, 4)).astype(np.float32)
    ct = _cotangent(rng, x, lambda v: _flax_pool(v, (2, 2), (2, 2)))
    for pool in JAX_POOLS.values():
        want_out, want_grad = _jax_forward_and_grad(
            lambda v: pool(v, (2, 2), (2, 2)), x, ct)
        out, grad = _forward_and_grad(x, ct, (2, 2), (2, 2))
        np.testing.assert_array_equal(out, want_out)
        np.testing.assert_array_equal(grad, want_grad)


@pytest.mark.parametrize("window,strides,shape", [
    ((3, 3), (3, 3), (2, 9, 12, 4)),    # non-overlapping
    ((2, 2), (1, 1), (2, 7, 9, 3)),     # overlapping stride-1
    ((3, 2), (2, 2), (2, 10, 8, 5)),    # asymmetric window
    ((4, 4), (2, 2), (1, 8, 8, 2)),     # window == 2*stride boundary
])
def test_other_window_stride_combos(window, strides, shape):
    rng = np.random.RandomState(12)
    x = rng.normal(size=shape).astype(np.float32)
    ct = _cotangent(rng, x, lambda v: _flax_pool(v, window, strides))
    out, grad = _forward_and_grad(x, ct, window, strides)
    for pool in JAX_POOLS.values():
        want_out, want_grad = _jax_forward_and_grad(
            lambda v: pool(v, window, strides), x, ct)
        np.testing.assert_array_equal(out, want_out)
        np.testing.assert_allclose(grad, want_grad, **BWD_TOL)


def test_window_past_twice_the_stride_matches_flax():
    # The JAX package's custom backward refuses window > 2*stride; the
    # port's pool takes it, and matches flax's pool.
    rng = np.random.RandomState(14)
    x = rng.normal(size=(2, 11, 9, 3)).astype(np.float32)
    pool = lambda v: _flax_pool(v, (5, 5), (2, 2))  # noqa: E731
    ct = _cotangent(rng, x, pool)
    want_out, want_grad = _jax_forward_and_grad(pool, x, ct)
    out, grad = _forward_and_grad(x, ct, (5, 5), (2, 2))
    np.testing.assert_array_equal(out, want_out)
    np.testing.assert_allclose(grad, want_grad, **BWD_TOL)


def test_channels_last_input_gives_the_same_values():
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.normal(size=(2, 3, 21, 21)).astype(np.float32))
    ct = torch.tensor(rng.normal(size=(2, 3, 11, 11)).astype(np.float32))
    grads = []
    for fmt in (torch.contiguous_format, torch.channels_last):
        xf = x.clone().to(memory_format=fmt).requires_grad_(True)
        out = max_pool_same(xf)
        grads.append((out, torch.autograd.grad(out, xf, ct)[0]))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
