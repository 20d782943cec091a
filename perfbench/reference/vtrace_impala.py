"""Plain reference of V-trace on ImpalaDeep (the ``dmlab_vtrace`` config).

Written from IMPALA (Espeholt et al. 2018, arXiv:1802.01561): the "deep"
net (3 residual stacks of 16/32/32 channels, each a 3x3 SAME conv, a 3x3/2
SAME max pool and 2 residual blocks of ReLU-conv-ReLU-conv; ReLU, Dense
256, ReLU; an LSTM over [features, reward clipped to ±1, one-hot previous
action] that starts from zero where ``done`` is set; policy logits and a
baseline), V-trace with ρ̄ = c̄ = 1, and the loss the configuration states:
the policy gradient on V-trace advantages, ``baseline_cost * 0.5`` times
the mean squared error to ``vs``, and the entropy bonus; then clip by
global norm and Adam (``common.py``).

``follow`` retraces the first training steps of a run from the weights
the benchmark drew and the unrolls the run produced. Of those it reads as
given only the actions, as a served model's tokens are read, and each
episode's hidden seed (both are the program's draws); it works out the
frames, rewards and ``done`` flags again from the synthetic env's formula
(``common.synthetic_env``), counts the run's that differ (``env``, which
has to be 0), and goes on from its own. Everything else it computes
itself: the behaviour
logits, baselines and carried LSTM state of the rollout (one continuous
pass over the global timesteps, with the weights each step was acted
with), the V-trace targets, each step's loss, the gradients, and the
weights after each Adam step. Its readings have the layout of the
program's (``builders/vtrace.py::check_steps``), so ``compare`` takes
either side.

Frames are converted and run through the torso in blocks of rows; the
torso's backward is taken block by block from the gradient of its output,
so the reference fits beside what the card still holds.
"""

from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.harness import check
from perfbench.reference import common

NEG_INF = float("-inf")


def parameter_shapes(config) -> Dict[str, tuple]:
    """The net's parameters by the program's names, in its order."""
    net = config["net"]
    h, w, cin = net["frame_shape"]
    shapes = {}
    for i, (ch, blocks) in enumerate(net["stacks"]):
        prefix = f"torso.stacks.{i}."
        shapes[prefix + "conv.weight"] = (ch, cin, 3, 3)
        shapes[prefix + "conv.bias"] = (ch,)
        for j in range(blocks):
            for k in range(2):
                shapes[f"{prefix}blocks.{j}.{k}.weight"] = (ch, ch, 3, 3)
                shapes[f"{prefix}blocks.{j}.{k}.bias"] = (ch,)
        cin, h, w = ch, -(-h // 2), -(-w // 2)
    out, lstm, actions = net["dense"], net["lstm"], net["num_actions"]
    shapes["torso.dense.weight"] = (out, h * w * cin)
    shapes["torso.dense.bias"] = (out,)
    shapes["lstm.cells.0.weight_ih"] = (4 * lstm, out + 1 + actions)
    shapes["lstm.cells.0.weight_hh"] = (4 * lstm, lstm)
    shapes["lstm.cells.0.bias"] = (4 * lstm,)
    shapes["policy_logits.weight"] = (actions, lstm)
    shapes["policy_logits.bias"] = (actions,)
    shapes["baseline.weight"] = (1, lstm)
    shapes["baseline.bias"] = (1,)
    return shapes


def max_pool_same(x):
    """3x3 max pool at stride 2 with TF's SAME padding (the extra pad row
    or column at the high end), padding with -inf."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((-(-size // 2) - 1) * 2 + 3 - size, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=NEG_INF), 3, 2)


def torso(p, frames, q, num_stacks):
    """uint8 [N, H, W, C] frames -> f32 [N, 256]."""
    x = q(frames.permute(0, 3, 1, 2).to(torch.float32) / 255.0)
    for i in range(num_stacks):
        s = f"torso.stacks.{i}."
        x = common.conv(x, p[s + "conv.weight"], p[s + "conv.bias"], q,
                        padding=1)
        x = max_pool_same(x)
        j = 0
        while f"{s}blocks.{j}.0.weight" in p:
            b = f"{s}blocks.{j}."
            y = common.conv(torch.relu(x), p[b + "0.weight"],
                            p[b + "0.bias"], q, padding=1)
            x = q(x + common.conv(torch.relu(y), p[b + "1.weight"],
                                  p[b + "1.bias"], q, padding=1))
            j += 1
    x = torch.relu(x).permute(0, 2, 3, 1).flatten(1)
    return torch.relu(common.linear(x, p["torso.dense.weight"],
                                    p["torso.dense.bias"], q))


class Net:
    """ImpalaDeep over a dict of parameters at a precision."""

    def __init__(self, config, precision: common.Precision, block: int):
        self.num_stacks = len(config["net"]["stacks"])
        self.num_actions = config["net"]["num_actions"]
        self.q = precision
        self.block = block

    def features(self, p, frames):
        """The torso over [N, ...] frames, in blocks, without gradients."""
        with torch.no_grad():
            return torch.cat([
                torso(p, frames[i:i + self.block], self.q.torso,
                      self.num_stacks)
                for i in range(0, frames.shape[0], self.block)])

    def torso_backward(self, p, frames, grad):
        """Accumulates d(torso . grad) into ``p``'s gradients, by blocks."""
        for i in range(0, frames.shape[0], self.block):
            out = torso(p, frames[i:i + self.block], self.q.torso,
                        self.num_stacks)
            out.backward(grad[i:i + self.block])

    def core(self, p, features, prev_action, reward, done, carry):
        """The LSTM and heads over time-major [T, B] inputs; returns the
        logits, baselines, the carry before each step and the last one."""
        q = self.q.core
        x = torch.cat([features, reward.clamp(-1.0, 1.0)[..., None],
                       F.one_hot(prev_action.long(), self.num_actions)
                       .to(torch.float32)], dim=-1)
        outputs, carries = [], []
        for t in range(x.shape[0]):
            carries.append(carry)
            carry, h = common.lstm_step(p, "lstm.cells.0.", x[t], carry,
                                        done[t], q)
            outputs.append(h)
        h = torch.stack(outputs)
        q = self.q.heads
        logits = common.linear(h, p["policy_logits.weight"],
                               p["policy_logits.bias"], q)
        baseline = common.linear(h, p["baseline.weight"], p["baseline.bias"],
                                 q).squeeze(-1)
        return logits, baseline, carries, carry


def vtrace(log_rhos, discounts, rewards, values, bootstrap):
    """V-trace targets and policy-gradient advantages, ρ̄ = c̄ = 1, λ = 1:
    ``vs_t = V(x_t) + Σ_{s≥t} γ^{s-t} (Π_{i<s} c_i) δ_s``, computed by the
    backward recursion ``vs_t - V_t = δ_t + γ_t c_t (vs_{t+1} - V_{t+1})``."""
    rhos = torch.exp(log_rhos)
    clipped = torch.clamp(rhos, max=1.0)
    cs = torch.clamp(rhos, max=1.0)
    next_values = torch.cat([values[1:], bootstrap[None]])
    deltas = clipped * (rewards + discounts * next_values - values)
    acc = torch.zeros_like(bootstrap)
    diffs = []
    for t in reversed(range(values.shape[0])):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        diffs.append(acc)
    vs = torch.stack(diffs[::-1]) + values
    next_vs = torch.cat([vs[1:], bootstrap[None]])
    pg_advantages = clipped * (rewards + discounts * next_vs - values)
    return vs, pg_advantages


def follow(config, traffic, inputs, precision, device, block: int = 1024):
    """The reference's readings over ``inputs["unrolls"]`` (one a training
    step) from the weights ``inputs["theta0"]``."""
    del traffic
    theta0 = inputs["theta0"]
    unrolls, env_mismatched = common.synthetic_env(
        config["env"], inputs["unrolls"], 0, device)
    knobs = config["learner"]
    net = Net(config, precision, block)
    params = {n: t.to(device, torch.float32).clone().requires_grad_(True)
              for n, t in theta0.items()}
    adam = common.Adam(knobs["learning_rate"], knobs["adam_b1"], 0.999,
                       knobs["adam_epsilon"], knobs["clip_norm"])
    history = [{n: t.detach().clone() for n, t in params.items()}]
    gamma = knobs["discounting"]
    readings = {"env": env_mismatched, "logits": [], "baseline": [],
                "core": [], "vtrace": [], "loss": []}
    lstm = config["net"]["lstm"]
    batch = unrolls[0]["reward"].shape[1]
    zeros = torch.zeros((batch, lstm), device=device)
    carry = (zeros, zeros)
    for k, unroll in enumerate(unrolls):
        u = {n: t.to(device) for n, t in unroll.items()}
        t_len = u["reward"].shape[0]
        frames = u["observation"].flatten(0, 1)
        readings["core"].append(carry)
        # The rollout: the unroll's first timestep was acted on with the
        # weights before the last update (the first unroll's with the
        # first weights), the T after it with the current ones.
        first, now = history[max(k - 1, 0)], history[k]
        with torch.no_grad():
            logits0, base0, _, after0 = net.core(
                first, net.features(first, frames[:batch])[None],
                u["prev_action"][:1], u["reward"][:1], u["done"][:1], carry)
            feats = net.features(now, frames[batch:])
            logits, base, carries, _ = net.core(
                now, feats.view(t_len - 1, batch, -1), u["prev_action"][1:],
                u["reward"][1:], u["done"][1:], after0)
            behaviour = torch.cat([logits0, logits])
        readings["logits"].append(behaviour)
        readings["baseline"].append(torch.cat([base0, base]))
        # The state before the last timestep, where the next unroll starts.
        next_carry = carries[-1]

        # The update, from the state the unroll starts with.
        feats = torch.cat([net.features(now, frames[:batch]), feats])
        feats.requires_grad_(True)
        logits, baseline, _, _ = net.core(
            params, feats.view(t_len, batch, -1), u["prev_action"],
            u["reward"], u["done"], carry)
        actions = u["action"][:-1].long()[..., None]
        logp = F.log_softmax(logits[:-1], -1)
        target_logp = logp.gather(-1, actions).squeeze(-1)
        behaviour_logp = F.log_softmax(behaviour[:-1], -1).gather(
            -1, actions).squeeze(-1)
        discounts = (~u["done"][1:]).to(torch.float32) * gamma
        values = baseline[:-1]
        with torch.no_grad():
            vs, pg_adv = vtrace(target_logp - behaviour_logp, discounts,
                                u["reward"][1:], values, baseline[-1])
        readings["vtrace"].append((vs, pg_adv))
        policy_loss = -torch.mean(target_logp * pg_adv)
        v_loss = knobs["baseline_cost"] * 0.5 * torch.mean(
            torch.square(vs - values))
        entropy = torch.mean(-torch.sum(logp.exp() * logp, -1))
        loss = policy_loss + v_loss - knobs["entropy_cost"] * entropy
        readings["loss"].append(float(loss.detach()))
        loss.backward()
        net.torso_backward(params, frames, feats.grad)
        clipped = adam.step(params, common.take_grads(params))
        history.append({n: t.detach().clone() for n, t in params.items()})
        if k == 0:
            readings["grad_norms"] = common.norms(clipped)
        carry = next_carry
    readings["change_norms"] = common.norms(
        {n: history[-1][n] - history[0][n] for n in params})
    # The entropy cost's parameter: no loss term reaches it (no target
    # entropy), so Adam leaves it where it is.
    readings["grad_norms"]["entropy_cost"] = 0.0
    readings["change_norms"]["entropy_cost"] = 0.0
    return readings


def compare(program, reference) -> Dict[str, float]:
    """The gaps of ``program``'s readings from ``reference``'s.

    ``env`` counts the elements of the run's env outputs that differ from
    the formula's (the reference's count). ``rollout`` takes the first unroll's logits and baselines and the LSTM
    state carried into the first two unrolls, ``vtrace`` and ``loss_first``
    the first step's targets and loss: what was computed with the drawn
    weights. Later unrolls and targets come from weights that Adam moved
    (β1 = 0, ε = 3.1e-7: a leaf's near-zero gradients step by ±lr on either
    side as rounding falls), which ``loss`` (each step's), ``grad`` and
    ``change`` hold."""
    first = [check.tensor_gap(program[key][0], reference[key][0])
             for key in ("logits", "baseline")]
    carried = [check.tensor_gap(p, r)
               for pair, ref in zip(program["core"][:2], reference["core"][:2])
               for p, r in zip(pair, ref)]
    return {
        "env": float(reference["env"]),
        "rollout": max(first + carried),
        "vtrace": max(check.tensor_gap(p, r) for p, r in zip(
            program["vtrace"][0], reference["vtrace"][0])),
        "loss": max(check.scalar_gap(p, r)
                    for p, r in zip(program["loss"], reference["loss"])),
        "loss_first": check.scalar_gap(program["loss"][0],
                                       reference["loss"][0]),
        "grad": check.leaf_norm_gap(program["grad_norms"],
                                    reference["grad_norms"]),
        "change": check.leaf_norm_gap(
            program["change_norms"], reference["change_norms"],
            check.moving_leaves(reference["grad_norms"])),
    }
