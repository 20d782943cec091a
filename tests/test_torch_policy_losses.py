"""Policy losses, loss coefficients and the KL regularizer of seed_rl_torch
against the JAX package (mirroring tests/test_policy_losses.py).

- Every factory (pg, vtrace_is, ppo with and without normalization and an
  offset, awr, bc_logp, vmpo, repeat_positive_advantages) takes the same
  advantages and log-probs as JAX: loss, logs and the gradients in the
  target log-probs and in the loss's own parameters agree within rtol
  1e-4 / atol 1e-6 (float32 sums, softmax and logsumexp in another
  order).
- The mask form of PPO clipping gives the clipped surrogate's gradient.
- ``LagrangeInequalityCoefficient``: value, adjustment loss and the clip
  after a step as in JAX, and it holds a constrained optimum in place.
- ``KLPolicyRegularizer`` with fixed and Lagrange coefficients, for a
  categorical and for a tanh-normal policy (its entropy a one-sample
  estimate from injected noise): per-step loss, adjustment loss, logs and
  gradients as in JAX.
"""

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seed_rl_tpu import distributions as jpd
from seed_rl_tpu.agents.ppo import constraints as jconstraints
from seed_rl_tpu.agents.ppo import policy_losses as jlosses
from seed_rl_tpu.agents.ppo.policy_regularizers import (
    KLPolicyRegularizer as JaxKLPolicyRegularizer,
)
from seed_rl_torch import distributions as tpd
from seed_rl_torch import optim
from seed_rl_torch.agents.ppo import constraints, policy_losses
from seed_rl_torch.agents.ppo.policy_regularizers import KLPolicyRegularizer

TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread, so that the other test
    processes sharing the cores do not stall every op's thread barrier
    (see tests/test_torch_ppo.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL, what=""):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.detach() if isinstance(
            g, torch.Tensor) else g), np.asarray(w), **tol, err_msg=what)


def _leaf_params(tree):
    """The JAX init_params tree as torch leaves that take gradients."""
    return jax.tree.map(
        lambda x: torch.tensor(np.asarray(x)).requires_grad_(True), tree)


FACTORIES = {
    "pg": lambda m: m.pg(),
    "vtrace_is": lambda m: m.vtrace_is(max_importance_weight=1.2),
    "ppo": lambda m: m.ppo(epsilon=0.2),
    "ppo-normalized-offset": lambda m: m.ppo(
        epsilon=0.1, normalize_advantages=True, advantage_offset=0.3),
    "awr": lambda m: m.awr(beta=0.5, w_max=3.0),
    "bc_logp": lambda m: m.bc_logp(),
    "vmpo": lambda m: m.vmpo(e_n=0.1),
    "repeat_positive_advantages": lambda m: m.repeat_positive_advantages(),
}


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_policy_loss_matches_jax(name):
    ours, theirs = FACTORIES[name](policy_losses), FACTORIES[name](jlosses)
    rng = np.random.RandomState(len(name))
    T, B = 5, 6
    adv = rng.normal(size=(T, B)).astype(np.float32)
    adv[0, :2] = adv[1, 0]  # ties at the V-MPO median
    b_logp = (rng.normal(size=(T, B)) * 0.3).astype(np.float32)
    t_logp = (b_logp + rng.normal(size=(T, B)) * 0.3).astype(np.float32)
    jparams = theirs.init_params()
    if name == "vmpo":  # a temperature away from its initial 1
        jparams = {"temperature": {"param": jnp.float32(-0.07)}}

    def jax_loss(params, tlp):
        return theirs(params, jnp.asarray(adv), tlp, jnp.asarray(b_logp))

    (jloss, jlogs), (jg_params, jg_logp) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(t_logp))

    params = _leaf_params(jparams)
    assert jax.tree.structure(params) == jax.tree.structure(
        ours.init_params())
    logp = torch.from_numpy(t_logp).requires_grad_(True)
    loss, logs = ours(params, torch.from_numpy(adv), logp,
                      torch.from_numpy(b_logp))
    assert set(logs) == set(jlogs)
    _close(loss, jloss, what="loss")
    for k in logs:
        _close(logs[k], jlogs[k], what=k)
    leaves = jax.tree.leaves(params)
    grads = torch.autograd.grad(loss, [logp] + leaves)
    _close(grads[0], jg_logp, what="dloss/dlogp")
    _close(list(grads[1:]), jax.tree.leaves(jg_params), what="dloss/dparams")


def test_ppo_mask_gives_the_clipped_surrogates_gradient():
    eps = 0.2
    rng = np.random.RandomState(1)
    T, B = 5, 6
    adv = torch.tensor(rng.normal(size=(T, B)), dtype=torch.float32)
    b_logp = torch.tensor(rng.normal(size=(T, B)) * 0.3, dtype=torch.float32)
    t_logp = torch.tensor(rng.normal(size=(T, B)) * 0.3, dtype=torch.float32)
    loss_obj = policy_losses.ppo(epsilon=eps)

    t1 = t_logp.clone().requires_grad_(True)
    (g_mask,) = torch.autograd.grad(
        loss_obj(loss_obj.init_params(), adv, t1, b_logp)[0], t1)
    t2 = t_logp.clone().requires_grad_(True)
    log_ratio = t2 - b_logp
    bound = math.log(1 + eps)
    clipped = torch.exp(torch.clamp(log_ratio, -bound, bound))
    surrogate = -torch.mean(torch.minimum(torch.exp(log_ratio) * adv,
                                          clipped * adv))
    (g_clip,) = torch.autograd.grad(surrogate, t2)
    torch.testing.assert_close(g_mask, g_clip, rtol=1e-4, atol=1e-6)


def test_advantage_preprocessor():
    prep = policy_losses.AdvantagePreprocessor(only_top_half=True)
    _, mask = prep(torch.tensor([[1.0, 2.0], [3.0, 4.0]]))
    torch.testing.assert_close(mask, torch.tensor([[0.0, 0.0], [1.0, 1.0]]))
    _, mask = policy_losses.AdvantagePreprocessor(only_positive=True)(
        torch.tensor([[-1.0, 2.0]]))
    torch.testing.assert_close(mask, torch.tensor([[0.0, 1.0]]))
    out, _ = policy_losses.AdvantagePreprocessor(normalize=True)(
        torch.tensor([[1.0, 2.0, 3.0, 4.0]]))
    assert abs(float(out.mean())) < 1e-6
    assert abs(float(out.std(correction=0)) - 1.0) < 1e-3


def test_lagrange_coefficient_matches_jax():
    coef = constraints.LagrangeInequalityCoefficient(
        threshold=0.5, init_alpha=2.0, alpha_range=(0.1, 5.0),
        adjustment_speed=3.0)
    jcoef = jconstraints.LagrangeInequalityCoefficient(
        threshold=0.5, init_alpha=2.0, alpha_range=(0.1, 5.0),
        adjustment_speed=3.0)
    _close(coef.init_params(), jcoef.init_params())
    x = np.array([0.2, 1.7], np.float32)
    for p in (-1.0, 0.1, 1.0):
        params = {"param": torch.tensor(p, requires_grad=True)}
        jparams = {"param": jnp.float32(p)}
        _close(coef.value(params), jcoef.value(jparams))

        def jax_loss(jp):
            return (jcoef.scale_loss(jp, jnp.asarray(x)).sum()
                    + jcoef.adjustment_loss(jp, jnp.asarray(x)))

        loss = (coef.scale_loss(params, torch.from_numpy(x)).sum()
                + coef.adjustment_loss(params, torch.from_numpy(x)))
        _close(loss, jax_loss(jparams))
        (grad,) = torch.autograd.grad(loss, params["param"])
        _close(grad, jax.grad(jax_loss)(jparams)["param"])
        with torch.no_grad():
            params["param"].add_(2.0)
        coef.postprocess_params_(params)
        _close(params, jcoef.postprocess_params(
            {"param": jparams["param"] + 2.0}))
    fixed = constraints.FixedCoefficient(0.3)
    assert fixed.init_params("cpu") == {}
    assert float(fixed.value({})) == pytest.approx(0.3)
    assert constraints.as_coefficient(fixed) is fixed
    assert isinstance(constraints.as_coefficient(2),
                      constraints.FixedCoefficient)


def test_lagrange_coefficient_enforces_the_inequality():
    """min (x-3)^2 s.t. x <= 2: the multiplier holds x at 2 and settles at
    the objective's slope there, 2."""
    coef = constraints.LagrangeInequalityCoefficient(threshold=2.0,
                                                     adjustment_speed=1.0)
    params = {"coef": coef.init_params(),
              "x": torch.tensor(0.5, requires_grad=True)}
    params["coef"]["param"].requires_grad_(True)
    opt = optim.ClippedAdam(jax.tree.leaves(params), learning_rate=0.01)
    xs, alphas = [], []
    for i in range(4000):
        opt.zero_grad()
        loss = (torch.square(params["x"] - 3.0)
                + coef.scale_loss(params["coef"], params["x"])
                + coef.adjustment_loss(params["coef"], params["x"]))
        loss.backward()
        opt.step()
        coef.postprocess_params_(params["coef"])
        if i >= 2000:  # Adam oscillates around the equilibrium
            xs.append(float(params["x"].detach()))
            alphas.append(float(coef.value(params["coef"]).detach()))
    assert np.mean(xs) == pytest.approx(2.0, abs=0.1)
    assert np.mean(alphas) == pytest.approx(2.0, abs=0.3)


REGULARIZERS = {
    "entropy-fixed": dict(entropy=0.5),
    "all-terms": dict(
        entropy=("lagrange", dict(threshold=-0.5, adjustment_speed=2.0)),
        kl_pi_mu=0.3,
        kl_mu_pi=("lagrange", dict(threshold=0.01)),
        kl_ref_pi=("lagrange", dict(threshold=0.2, init_alpha=0.5)),
    ),
}


def _coefficients(spec, module):
    return {k: (module.LagrangeInequalityCoefficient(**v[1])
                if isinstance(v, tuple) else v) for k, v in spec.items()}


@pytest.mark.parametrize("dist_kind", ["categorical", "normal_tanh"])
@pytest.mark.parametrize("spec", sorted(REGULARIZERS))
def test_kl_regularizer_matches_jax(spec, dist_kind):
    spec = REGULARIZERS[spec]
    reg = KLPolicyRegularizer(**_coefficients(spec, constraints))
    jreg = JaxKLPolicyRegularizer(**_coefficients(spec, jconstraints))
    T, B, A = 3, 4, 3
    if dist_kind == "categorical":
        dist, jdist, width = (tpd.CategoricalDistribution(A),
                              jpd.CategoricalDistribution(A), A)
    else:
        dist, jdist, width = (tpd.NormalTanhDistribution(A),
                              jpd.NormalTanhDistribution(A), 2 * A)
    rng = np.random.RandomState(7)
    pi = rng.normal(size=(T, B, width)).astype(np.float32)
    mu = rng.normal(size=(T, B, width)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    # The draw the JAX entropy estimate makes from its key.
    noise = jax.random.normal(key, (T, B, A), jnp.float32)
    jparams = jreg.init_params()

    def jax_reg(params, pi_logits):
        per_step, global_loss, logs = jreg(params, jdist, pi_logits,
                                           jnp.asarray(mu), None, rng=key)
        return jnp.sum(per_step) + global_loss, (per_step, global_loss, logs)

    (_, (jper, jglobal, jlogs)), (jg_params, jg_pi) = jax.value_and_grad(
        jax_reg, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(pi))

    params = _leaf_params(jparams)
    pi_t = torch.from_numpy(pi).requires_grad_(True)
    per, global_loss, logs = reg(params, dist, pi_t, torch.from_numpy(mu),
                                 None, noise=torch.tensor(np.asarray(noise)))
    _close(per, jper, what="per-step")
    _close(global_loss, jglobal, what="global")
    assert set(logs) == set(jlogs)
    for k in logs:
        _close(logs[k], jlogs[k], what=k)
    grads = torch.autograd.grad(per.sum() + global_loss,
                                [pi_t] + jax.tree.leaves(params),
                                allow_unused=True)
    _close(grads[0], jg_pi, what="d/dpi")
    for g, w in zip(grads[1:], jax.tree.leaves(jg_params)):
        _close(g, w, what="d/dparams")


def test_kl_regularizer_terms_on_known_policies():
    dist = tpd.CategoricalDistribution(4)
    reg = KLPolicyRegularizer(entropy=0.5)
    logits = torch.zeros((2, 3, 4))
    per_step, global_loss, logs = reg(reg.init_params(), dist, logits,
                                      logits, None)
    # Uniform: entropy log 4, per-step loss 0.5 * -log 4.
    torch.testing.assert_close(per_step,
                               torch.full((2, 3), -0.5 * math.log(4.0)))
    assert float(global_loss) == 0.0
    assert float(logs["KLPolicyRegularizer/entropy"]) == pytest.approx(
        math.log(4.0))
    reg = KLPolicyRegularizer(kl_pi_mu=1.0, kl_mu_pi=1.0)
    logits = torch.randn((2, 2, 3), generator=torch.Generator().manual_seed(0))
    per_step, _, _ = reg(reg.init_params(), tpd.CategoricalDistribution(3),
                         logits, logits, None)
    torch.testing.assert_close(per_step, torch.zeros((2, 2)))
    with pytest.raises(ValueError):
        KLPolicyRegularizer(entropie=1.0)


def test_unreached_parameter_steps_like_optax():
    """A loss-owned parameter the loss stops reaching keeps stepping on its
    Adam moments, with the shared update count, as optax moves it."""
    import optax

    a = torch.tensor([0.5, -1.0], requires_grad=True)
    b = torch.tensor(2.0, requires_grad=True)
    opt = optim.ClippedAdam([a, b], learning_rate=0.1, clip_norm=1.0)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(0.1))
    params = {"a": jnp.array([0.5, -1.0]), "b": jnp.float32(2.0)}
    state = tx.init(params)

    def jax_loss(p, both):
        loss = jnp.sum(jnp.square(p["a"] - 3.0))
        return loss + (jnp.square(p["b"]) if both else 0.0)

    for step in range(4):
        both = step == 0  # b is reached by the first loss only
        opt.zero_grad()
        loss = torch.sum(torch.square(a - 3.0))
        if both:
            loss = loss + torch.square(b)
        loss.backward()
        assert (b.grad is None) == (not both)
        opt.step()
        grads = jax.grad(functools.partial(jax_loss, both=both))(params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        _close([a, b], [params["a"], params["b"]], what=f"step {step}")
        if step == 0:
            b_reached = float(b.detach())
    # It moved on its moments after the loss stopped reaching it.
    assert float(b.detach()) < b_reached - 0.1
