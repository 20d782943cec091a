"""Example ``--agent_module``: a free loss x net x optimizer composition.

The port of ``scripts/examples/custom_ppo_composition.py`` out of
``seed_rl_torch``'s own modules. It rebuilds the PPO loss as V-MPO over
V-trace advantages with PopArt compensation, behind a wider net (3 x 128
tanh, EMA input normalization) and a cosine-decayed AdamW: a composition
the CLI's flags alone do not reach.

    python -m seed_rl_torch.train --agent=ppo --env=toy \
        --agent_module=seed_rl_torch/examples/custom_ppo_composition.py ...

Where the JAX example chains optax transforms, ``optimizer`` here is a
factory ``params -> optimizer``: ``optim.ClippedAdam`` on a learning-rate
schedule (optax's ``cosine_decay_schedule``) with a decoupled
``weight_decay`` (``optax.adamw``'s).
"""

import functools
import math

import torch

# The schedule's horizon in optimizer updates (the JAX example's).
DECAY_STEPS = 10_000


def configure(args, env, components):
    from seed_rl_torch import optim
    from seed_rl_torch.agents.ppo import policy_losses
    from seed_rl_torch.agents.ppo.continuous_control_agent import (
        ContinuousControlNet,
        NormalizingPolicyAgent,
    )
    from seed_rl_torch.agents.ppo.generalized_onpolicy_loss import (
        GeneralizedOnPolicyLoss,
    )
    from seed_rl_torch.agents.ppo.input_normalization import (
        InputNormalization,
    )
    from seed_rl_torch.agents.ppo.policy_regularizers import (
        KLPolicyRegularizer,
    )
    from seed_rl_torch.ops.advantages import VTrace
    from seed_rl_torch.ops.popart import PopArt
    from seed_rl_torch.ops.running_statistics import EMAMeanStd

    dist = components["dist"]
    device = next(components["net"].parameters()).device
    obs_size = math.prod(env.observation_spec().shape)

    net = ContinuousControlNet(
        parametric_distribution_param_size=dist.param_size,
        input_size=obs_size,
        num_layers_policy=3,
        num_layers_value=3,
        num_units_policy=128,
        num_units_value=128,
        activation=torch.tanh,
        kernel_init_gain=math.sqrt(2.0),
        last_kernel_init_policy_gain=0.01,
        last_kernel_init_value_gain=1.0,
        std_independent_of_input=True,
        seed=0,
        device=device,
    )
    agent = NormalizingPolicyAgent(
        net,
        dist,
        input_normalization=InputNormalization(
            EMAMeanStd(std_min_value=1e-3), input_size=obs_size),
        input_clipping=10.0,
    )
    loss = GeneralizedOnPolicyLoss(
        agent=agent,
        reward_normalizer=PopArt(EMAMeanStd(), compensate=True),
        parametric_action_distribution=dist,
        advantage_estimator=VTrace(lambda_=0.9),
        policy_loss=policy_losses.vmpo(e_n=0.02),
        discount_factor=args.discounting,
        regularizer=KLPolicyRegularizer(entropy=1e-3),
        baseline_cost=0.5,
    )
    optimizer = functools.partial(
        optim.ClippedAdam,
        learning_rate=optim.cosine_decay_schedule(args.learning_rate,
                                                  DECAY_STEPS),
        clip_norm=args.clip_norm,
        weight_decay=1e-4,
    )
    components.update(net=net, agent=agent, loss=loss, optimizer=optimizer)
    return components
