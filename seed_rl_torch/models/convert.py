"""Carries flax parameters over into the port's modules.

Takes a flax parameter tree of the JAX package's networks, as nested dicts
of numpy arrays (with or without the top-level ``"params"`` key), and
returns the ``state_dict`` of the port's counterpart:
- flax ``Dense`` ``kernel [in, out]`` -> ``Linear.weight [out, in]``;
  ``bias`` as is;
- flax ``Conv`` ``kernel [kh, kw, in, out]`` (HWIO) -> ``Conv2d.weight
  [out, in, kh, kw]`` (OIHW); ``bias`` as is;
- ``nn.OptimizedLSTMCell``'s per-gate ``ii/if/ig/io`` kernels and
  ``hi/hf/hg/ho`` kernels and biases -> ``LSTMCell.weight_ih``,
  ``weight_hh`` and ``bias``, gates stacked in the order i, f, g, o.

The pixel nets flatten their conv output in flax's (H, W, C) order (see
``models/atari.py``), so the Dense after the convs maps like any other.

Any tree of the same structure converts the same way, so a gradient tree
of the JAX package lands on the port's ``.grad`` layout too.

Networks: ``MLPAndLSTM``, ``MLPPolicyNetwork``, ``VectorDuelingDQNNet``
(whose single ``lstm`` cell and bias-free ``advantage_head`` map as above),
``AtariPolicyNet`` (flax's scanned ``core/lstm`` -> ``core.cells.0``),
``DuelingLSTMDQNNet`` (the same torso and core, then the dueling heads
named as in ``VectorDuelingDQNNet``) and ``ImpalaDeep``
(``torso/ResidualStack_k/Conv_0`` -> ``torso.stacks.k.conv``,
``res_i_conv{0,1}`` -> ``torso.stacks.k.blocks.i.{0,1}``), ``GFootball``
(its unnamed ``ImpalaResNetTorso_0`` -> ``torso``, mapped as
``ImpalaDeep``'s), and the PPO
family's ``ContinuousControlNet`` (``{shared,policy,value}_torso/Dense_i``
and ``LayerNorm_i`` -> ``*.layers.i`` and ``*.norms.i``, flax's LayerNorm
``scale`` -> ``weight``; ``lstm_i`` -> ``lstm.cells.i``; the free log-std
and the observation-correction affine as they are), and the SAC nets:
``ActorCriticMLP`` and ``VisualActorCritic`` (``actor`` / ``v`` / ``q_i``,
each ``Dense_k`` -> ``actor`` / ``v`` / ``q.i`` ``.layers.k``; the visual
net's torso as ``AtariPolicyNet``'s) and ``ActorCriticLSTM`` (per net
``pre_mlp``, ``ff_mlp`` and ``post_mlp`` as MLPs, and the LSTM cells one
level deeper under ``nn.scan``'s wrapper: ``lstm/core/lstm_i`` ->
``core.cells.i``).
"""

from typing import Dict, Tuple

import numpy as np
import torch

from seed_rl_torch.agents.ppo.continuous_control_agent import (
    ContinuousControlNet,
)
from seed_rl_torch.models.atari import AtariPolicyNet, DuelingLSTMDQNNet
from seed_rl_torch.models.dueling_mlp import VectorDuelingDQNNet
from seed_rl_torch.models.policy import MLPAndLSTM, MLPPolicyNetwork
from seed_rl_torch.models.resnets import GFootball, ImpalaDeep
from seed_rl_torch.models.sac_nets import (
    ActorCriticLSTM,
    ActorCriticMLP,
    VisualActorCritic,
)

_GATES = "ifgo"


def _tensor(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def _unwrap(tree):
    return tree["params"] if "params" in tree else tree


def _dense(tree, prefix: str) -> Dict[str, torch.Tensor]:
    return {
        prefix + "weight": _tensor(np.asarray(tree["kernel"]).T),
        prefix + "bias": _tensor(tree["bias"]),
    }


def _conv(tree, prefix: str) -> Dict[str, torch.Tensor]:
    return {
        prefix + "weight": _tensor(
            np.transpose(np.asarray(tree["kernel"]), (3, 2, 0, 1))),
        prefix + "bias": _tensor(tree["bias"]),
    }


def _lstm_cell(tree, prefix: str) -> Dict[str, torch.Tensor]:
    def stacked(kind):
        return np.concatenate(
            [np.asarray(tree[f"{kind}{g}"]["kernel"]) for g in _GATES], axis=1
        ).T

    bias = np.concatenate([np.asarray(tree[f"h{g}"]["bias"]) for g in _GATES])
    return {
        prefix + "weight_ih": _tensor(stacked("i")),
        prefix + "weight_hh": _tensor(stacked("h")),
        prefix + "bias": _tensor(bias),
    }


def _indexed(tree, stem: str):
    """``Dense_0, Dense_1, ...`` (or ``lstm_0, ...``) in numeric order."""
    keys = sorted(
        (k for k in tree if k.startswith(stem)),
        key=lambda k: int(k[len(stem):]),
    )
    return [tree[k] for k in keys]


def _mlp_torso(tree, prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    for i, layer in enumerate(_indexed(tree, "Dense_")):
        out.update(_dense(layer, f"{prefix}layers.{i}."))
    return out


def _heads(p) -> Dict[str, torch.Tensor]:
    return {**_dense(p["policy_logits"], "policy_logits."),
            **_dense(p["baseline"], "baseline.")}


def mlp_and_lstm_state_dict(params) -> Dict[str, torch.Tensor]:
    p = _unwrap(params)
    out = _mlp_torso(p["MLPTorso_0"], "torso.")
    for i, cell in enumerate(_indexed(p["LSTMStack_0"], "lstm_")):
        out.update(_lstm_cell(cell, f"lstm.cells.{i}."))
    out.update(_heads(p))
    return out


def mlp_policy_network_state_dict(params) -> Dict[str, torch.Tensor]:
    p = _unwrap(params)
    if "MLPTorso_0" in p:  # shared torso
        out = _mlp_torso(p["MLPTorso_0"], "torso.")
    else:
        out = _mlp_torso(p["policy_torso"], "policy_torso.")
        out.update(_mlp_torso(p["value_torso"], "value_torso."))
    out.update(_heads(p))
    return out


def _dueling_heads(p) -> Dict[str, torch.Tensor]:
    out = {}
    for name in ("hidden_value", "value_head", "hidden_advantage"):
        out.update(_dense(p[name], f"{name}."))
    out["advantage_head.weight"] = _tensor(
        np.asarray(p["advantage_head"]["kernel"]).T
    )
    return out


def vector_dueling_dqn_net_state_dict(params) -> Dict[str, torch.Tensor]:
    p = _unwrap(params)
    out = _mlp_torso(p["MLPTorso_0"], "torso.")
    out.update(_lstm_cell(p["lstm"], "lstm.cells.0."))
    out.update(_dueling_heads(p))
    return out


def _atari_torso(torso) -> Dict[str, torch.Tensor]:
    out = {}
    for i, layer in enumerate(_indexed(torso, "Conv_")):
        out.update(_conv(layer, f"torso.convs.{i}."))
    out.update(_dense(torso["Dense_0"], "torso.dense."))
    return out


def atari_policy_net_state_dict(params) -> Dict[str, torch.Tensor]:
    p = _unwrap(params)
    out = _atari_torso(p["torso"])
    if "core" in p:
        out.update(_lstm_cell(p["core"]["lstm"], "core.cells.0."))
    out.update(_heads(p))
    return out


def dueling_lstm_dqn_net_state_dict(params) -> Dict[str, torch.Tensor]:
    p = _unwrap(params)
    out = _atari_torso(p["torso"])
    out.update(_lstm_cell(p["core"]["lstm"], "core.cells.0."))
    out.update(_dueling_heads(p))
    return out


def _impala_torso(torso) -> Dict[str, torch.Tensor]:
    out = {}
    for k, stack in enumerate(_indexed(torso, "ResidualStack_")):
        prefix = f"torso.stacks.{k}."
        out.update(_conv(stack["Conv_0"], prefix + "conv."))
        i = 0
        while f"res_{i}_conv0" in stack:
            for j in range(2):
                out.update(_conv(stack[f"res_{i}_conv{j}"],
                                 f"{prefix}blocks.{i}.{j}."))
            i += 1
    out.update(_dense(torso["Dense_0"], "torso.dense."))
    return out


def impala_deep_state_dict(params) -> Dict[str, torch.Tensor]:
    p = _unwrap(params)
    return {**_impala_torso(p["torso"]),
            **_lstm_cell(p["lstm"], "lstm.cells.0."), **_heads(p)}


def gfootball_state_dict(params) -> Dict[str, torch.Tensor]:
    p = _unwrap(params)
    return {**_impala_torso(p["ImpalaResNetTorso_0"]), **_heads(p)}


def continuous_control_net_state_dict(params) -> Dict[str, torch.Tensor]:
    p = _unwrap(params)
    out = {}
    for torso in ("shared_torso", "policy_torso", "value_torso"):
        if torso not in p:
            continue
        for i, layer in enumerate(_indexed(p[torso], "Dense_")):
            out.update(_dense(layer, f"{torso}.layers.{i}."))
        for i, norm in enumerate(_indexed(p[torso], "LayerNorm_")):
            out[f"{torso}.norms.{i}.weight"] = _tensor(norm["scale"])
            out[f"{torso}.norms.{i}.bias"] = _tensor(norm["bias"])
    for i, cell in enumerate(_indexed(p, "lstm_")):
        out.update(_lstm_cell(cell, f"lstm.cells.{i}."))
    out.update(_dense(p["policy_head"], "policy_head."))
    out.update(_dense(p["value_head"], "value_head."))
    for name in ("free_log_std", "obs_correction_scale",
                 "obs_correction_bias"):
        if name in p:
            out[name] = _tensor(p[name])
    return out


def _sac_heads(p, convert) -> Dict[str, torch.Tensor]:
    """``actor``, ``v`` and ``q_0, q_1, ...``, each through ``convert``."""
    out = {**convert(p["actor"], "actor."), **convert(p["v"], "v.")}
    for i, q in enumerate(_indexed(p, "q_")):
        out.update(convert(q, f"q.{i}."))
    return out


def actor_critic_mlp_state_dict(params) -> Dict[str, torch.Tensor]:
    return _sac_heads(_unwrap(params), _mlp_torso)


def visual_actor_critic_state_dict(params) -> Dict[str, torch.Tensor]:
    p = _unwrap(params)
    return {**_atari_torso(p["torso"]), **_sac_heads(p, _mlp_torso)}


def _lstm_with_ff_branch(tree, prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    for mlp in ("pre_mlp", "ff_mlp", "post_mlp"):
        out.update(_mlp_torso(tree[mlp], f"{prefix}{mlp}."))
    for i, cell in enumerate(_indexed(tree["lstm"]["core"], "lstm_")):
        out.update(_lstm_cell(cell, f"{prefix}core.cells.{i}."))
    return out


def actor_critic_lstm_state_dict(params) -> Dict[str, torch.Tensor]:
    return _sac_heads(_unwrap(params), _lstm_with_ff_branch)


def state_dict_for(net: torch.nn.Module, params) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``net``'s type built from a flax tree."""
    if isinstance(net, MLPAndLSTM):
        return mlp_and_lstm_state_dict(params)
    if isinstance(net, MLPPolicyNetwork):
        return mlp_policy_network_state_dict(params)
    if isinstance(net, VectorDuelingDQNNet):
        return vector_dueling_dqn_net_state_dict(params)
    if isinstance(net, AtariPolicyNet):
        return atari_policy_net_state_dict(params)
    if isinstance(net, DuelingLSTMDQNNet):
        return dueling_lstm_dqn_net_state_dict(params)
    if isinstance(net, ImpalaDeep):
        return impala_deep_state_dict(params)
    if isinstance(net, GFootball):
        return gfootball_state_dict(params)
    if isinstance(net, ContinuousControlNet):
        return continuous_control_net_state_dict(params)
    if isinstance(net, ActorCriticMLP):
        return actor_critic_mlp_state_dict(params)
    if isinstance(net, VisualActorCritic):
        return visual_actor_critic_state_dict(params)
    if isinstance(net, ActorCriticLSTM):
        return actor_critic_lstm_state_dict(params)
    raise TypeError(f"no flax converter for {type(net).__name__}")


def vtrace_params(
    net: torch.nn.Module, params
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The JAX V-trace learner's ``{"net": ..., "entropy_cost": ...}`` tree
    as (net state_dict, entropy-cost scalar)."""
    return state_dict_for(net, params["net"]), _tensor(params["entropy_cost"])
